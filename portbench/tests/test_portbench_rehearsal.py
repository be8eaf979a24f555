"""``run.py`` end to end on the CPU (the kernels' plain versions, tiny
shards), its refusals, and its last line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import pytest

from portbench.harness import spec

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
RUN = ["python3", "portbench/run.py"]
SMALL = ["--device", "cpu", "--shard-bytes", "2048", "--shards", "3"]


def _run(args, cwd=spec.ROOT, env=None):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(cell):
    r = _run(["--workload", cell, "--seed", str(2**31 + 7), "--seconds",
              "0.3", "--trace", "0", *SMALL])
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    c = spec.load_cell(cell)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    # a CPU run writes no number under a metric's name
    assert all(m["value"] is None for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    tail = r.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, chk), text in zip(line["checks"].items(), tail):
        assert text == f"check {name}: {chk['value']} (limit {chk['limit']})"


def test_same_seed_same_inputs():
    corpus = spec.load_module(spec.BENCH / "corpora" / "zipf-text.py",
                              "t_corpus2")
    text = spec.load_cell(CELLS[0]).config["assumed"]["corpus"]
    a = corpus.make_inputs(text, 2**33 + 1, 2, 3, 5000)
    b = corpus.make_inputs(text, 2**33 + 1, 2, 3, 5000)
    c = corpus.make_inputs(text, 2**33 + 2, 2, 3, 5000)
    assert a == b and a != c and a[0] != a[1]
    assert [len(x) for x in a] == [15000, 15000]


def test_no_card_no_result():
    r = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
              "--trace", "0"])
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_bare_checkout_refuses(tmp_path):
    """BENCHMARK.json and the benchmark's folder alone: no program, no
    result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
              "--trace", "0", *SMALL], cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_rehearsal_flags_refused_on_the_card():
    r = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
              "--shard-bytes", "2048"])
    assert r.returncode != 0 and not r.stdout.strip()
