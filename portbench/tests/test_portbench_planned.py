"""The planned encode's cell (``ext-planned-w10.encode.64x1m``, entry point
``compress_planned``) on the CPU at a tiny size: sound runs read correct;
its control (the greedy path) and the three planted faults of a codec cell
(a stale result, half the shards, a byte altered in every stream) read not
correct; and its plain planned encoder loads nothing of the program or of
JAX."""

from __future__ import annotations

import subprocess
import sys

import pytest

from portbench.harness import main, spec
from portbench.harness.main import execute, parse_args
from portbench.tests.test_portbench_faults import FAULTS, _faulty

CELL = "ext-planned-w10.encode.64x1m"


def _line(replace=None, shard_bytes=4096, shards=2):
    return execute(parse_args([
        "--workload", CELL, "--seed", str(2**32 + 11), "--seconds", "0.3",
        "--device", "cpu", "--shard-bytes", str(shard_bytes), "--shards",
        str(shards)]), 0.0, replace)


def test_the_cell_uses_the_planned_entry_point():
    c = spec.load_cell(CELL)
    assert c.traffic["op"] == "compress_planned"
    assert c.config["engine"] == "device-commit"
    assert c.config["control"] == {"engine": "native"}


def test_sound():
    line = _line()
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"calls_failed", "frame_faults",
                                   "streams_unequal", "bytes_wrong"}
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())


def test_control_is_not_correct():
    # the greedy streams depart from the planned walk's on 64 KiB of text
    line = _line(lambda run: run.entry.control(run), 65536)
    assert line["correct"] is False
    assert line["checks"]["streams_unequal"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    from tamp_tpu_torch.parallel import shard

    orig = shard._encoder
    last: list = []
    monkeypatch.setattr(shard, "_encoder", lambda *a, **k: _faulty(
        orig(*a, **k), fault, last))
    line = _line(shards=4, shard_bytes=2048)
    assert line["correct"] is False, (fault, line["checks"])


def test_the_planned_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.check_planned; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"tamp_tpu_torch", "torch", *main.FORBIDDEN}
