"""No module a run loads is JAX's or the JAX package's, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench.harness import main, spec

FILES = sorted(p for p in spec.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(main.FORBIDDEN)
    if path.parent.name == "reference":
        assert "tamp_tpu_torch" not in tops and "torch" not in tops


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"tamp_tpu_torch", "torch", *main.FORBIDDEN}


def test_forbidden_names_compare_whole(monkeypatch):
    base = set(main.forbidden_modules())
    for name in ("tamp_tpu_torch.x", "jaxfoo", "tamp_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(main.forbidden_modules()) == base
    for name in ("tamp_tpu.engine", "jaxlib", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(main.forbidden_modules()) - base == {
        "tamp_tpu.engine", "jaxlib", "jax.numpy", "flax"}


def test_a_rehearsal_loads_none_of_them():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench.harness.main import execute, parse_args, "
        "forbidden_modules;"
        "execute(parse_args(['--workload', 'ext-w10.devdecode.8x1m', "
        "'--seed', '3', '--seconds', '0.2', '--device', 'cpu', "
        "'--shard-bytes', '2048', '--shards', '2']), 0.0);"
        "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_metric_that_loads_the_jax_package_refuses_the_line(tmp_path):
    """The look for forbidden modules comes after every metric reader has
    been loaded: a copy of the benchmark whose cell gains a metric that
    imports a stand-in ``tamp_tpu`` exits nonzero and prints no result."""
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "tamp_tpu").mkdir()
    (tmp_path / "tamp_tpu" / "__init__.py").write_text("")
    (tmp_path / "portbench/metrics/leak.py").write_text(
        "import tamp_tpu  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["end_to_end"].append({
        "name": "leak", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "5", "--seconds", "0.2", "--trace", "0", "--device", "cpu",
         "--shard-bytes", "2048", "--shards", "2"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(spec.ROOT)})
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "tamp_tpu" in r.stderr.strip().splitlines()[-1]
