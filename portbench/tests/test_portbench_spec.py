"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess

import pytest

from portbench.harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    # the command names no file outside paths
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else
                         x.get("name"))
def test_entry_keys_and_names(group, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    extra = set(entry) - keys
    assert set(entry) >= keys
    assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                     else set())
    assert spec.NAME.match(entry["name"])
    for k in ("why", "layer") + (("source",) if group == "configs" else ()):
        if k in entry:
            assert LINE.match(entry[k])
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert entry["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        if entry["name"].endswith("_roofline"):
            assert entry["unit"] == "%"
    if group == "workloads":
        assert entry["chips"] in (1, 4)
        assert spec.NAME.match(entry["config"])
        assert spec.NAME.match(entry["traffic"])


def test_unique_names_and_one_file_a_config():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert all(spec.NAME.match(k) for k in entry["reduced"])
    # each configuration serves some cell
    assert entry["name"] in [w["config"] for w in BENCH["workloads"]]
    (spec.BENCH / "corpora" / f"{cfg['data']}.py").resolve(strict=True)


def test_cells_report_what_the_contract_asks():
    where = spec.cells(BENCH)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        name = w["name"]
        assert name in where["setup_s"]
        assert any(name in where[m] for m in e2e - {"setup_s"})
        assert any(name in where[m["name"]] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert set(where[m["name"]]) <= set(where[m["moves"]])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert (c.dir / "entries" / f"{c.traffic['op']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert (c.dir / "metrics" / f"{m['name']}.py").is_file()
    mod = spec.load_module(c.dir / "entries" / f"{c.traffic['op']}.py",
                           "t_entry")
    for fn in ("setup", "call", "account", "check", "control",
               "containers"):
        assert callable(getattr(mod, fn))


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a configuration (the ``match`` corpus
    as data), a traffic mix and a per-layer metric as new files and new
    entries, and runs as a rehearsal: no file that was there is edited."""
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "tamp-ext-w10-l8-match"
    cfg["assumed"]["corpus"].update(vocabulary=48, zipf_exponent=0.0,
                                    run_share=0.0)
    (tmp_path / "portbench/configs/tamp-ext-w10-l8-match.json").write_text(
        json.dumps(cfg))
    traffic = {"op": "compress_sharded", "shards": 3, "shard_bytes": 2048,
               "pool": 2, "warm_calls": 1, "keep": 1, "check_shards": 2,
               "trace_calls": 2}
    (tmp_path / "portbench/traffic/encode.3x2k.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/calls_done.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    bench["configs"].append({
        "name": cfg["name"], "source": "https://example.org/match",
        "file": "portbench/configs/tamp-ext-w10-l8-match.json",
        "reduced": cfg["reduced"], "why": "long matches"})
    bench["workloads"].append({
        "name": "match.encode.3x2k", "config": cfg["name"],
        "traffic": "encode.3x2k", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "ratio":
            m["workloads"].append("match.encode.3x2k")
    bench["per_layer"].append({
        "name": "calls_done", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "container API",
        "moves": "ratio", "workloads": ["match.encode.3x2k"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = spec.load_cell("match.encode.3x2k", path)
    assert cell.traffic == traffic and cell.config["name"] == cfg["name"]
    assert [m["name"] for m in cell.per_layer] == ["calls_done"]
    # the copy's own run.py: its portbench/ and BENCHMARK.json, the program
    # from this checkout
    r = subprocess.run(
        ["python3", "portbench/run.py", "--workload", "match.encode.3x2k",
         "--seed", "2", "--seconds", "0.2", "--trace", "0", "--device",
         "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert set(line["rehearsal"]) == {"setup_s", "ratio"}
    assert line["rehearsal"]["ratio"] < 0.5  # 48 words: long matches
    after = {p: p.read_bytes() for p in before}
    assert after == before
