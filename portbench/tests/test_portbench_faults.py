"""``correct`` comes out false when the timed path is broken underneath,
and for each cell's control; true for the program as it is.  On the CPU
(the kernels' plain versions) at a tiny size: the harness's look for a card
is skipped, the rest of a run is driven.

The faults a codec cell can have: a call that returns its previous result
(its state left unchanged), half of the batch's shards left out, and a
byte altered in every stream or output where it is produced.  No cell
exchanges anything between chips."""

from __future__ import annotations

import json

import pytest

from portbench.harness import spec
from portbench.harness.main import execute, parse_args

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = ("stale", "half", "altered")


def _line(cell, replace=None, shard_bytes=2048):
    return execute(parse_args([
        "--workload", cell, "--seed", str(2**32 + 5), "--seconds", "0.3",
        "--device", "cpu", "--shard-bytes", str(shard_bytes), "--shards",
        "4"]), 0.0, replace)


def _faulty(fn, fault, last):
    """``fn`` (a batch encode or decode: a list in, a list out) with the
    fault planted; ``last`` holds the previous call's result."""

    def broken(items, *a, **k):
        out = list(fn(items, *a, **k))
        if fault == "stale":
            prev = last[:] or out
            last[:] = out
            return prev
        if fault == "half":
            return out[: len(out) // 2] + [b""] * (len(out)
                                                  - len(out) // 2) \
                if "max_out" in k else out[: len(out) // 2]
        mid = [bytearray(x) for x in out]
        for x in mid:
            if len(x) > 1:
                x[len(x) // 2] ^= 0x10
        return [bytes(x) for x in mid]

    return broken


def _plant(monkeypatch, cell, fault):
    from tamp_tpu_torch.ops import decode_serial, decode_wavefront
    from tamp_tpu_torch.parallel import shard

    op = spec.load_cell(cell).traffic["op"]
    last: list = []
    if op == "compress_sharded":
        orig = shard._encoder
        monkeypatch.setattr(shard, "_encoder", lambda *a, **k: _faulty(
            orig(*a, **k), fault, last))
    elif op == "decompress_sharded":
        monkeypatch.setattr(decode_serial, "decode_shards_device", _faulty(
            decode_serial.decode_shards_device, fault, last))
    else:
        monkeypatch.setattr(
            decode_wavefront, "decode_shards_wavefront", _faulty(
                decode_wavefront.decode_shards_wavefront, fault, last))


@pytest.mark.parametrize("cell", CELLS)
def test_sound(cell):
    line = _line(cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(monkeypatch, cell, fault):
    _plant(monkeypatch, cell, fault)
    line = _line(cell)
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    # the planned committer departs from the greedy streams only now and
    # then: shards of 64 KiB show it
    line = _line(cell, lambda run: run.entry.control(run), 65536)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
