"""The port's measuring tools on the CPU (``tools/torch_*.py`` at tiny
sizes, ``--device cpu``), the JAX package's last five public names in the
port, each held against the JAX package on seeded inputs, and the import
rule of the bench and the tools (no JAX, nothing of ``tamp_tpu``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench_torch
from tamp_tpu import _native
from tamp_tpu.cli import main as jcli
from tamp_tpu.constants import HUFFMAN_DECODE_TABLE as JAX_TABLE
from tamp_tpu.dictionary import dictionary_array
from tamp_tpu.engine import encode as jencode
from tamp_tpu.ops.decode_wavefront import (
    wavefront_decode_payload as jax_payload,
)
from tamp_tpu_torch.cli import main as tcli
from tamp_tpu_torch.constants import HUFFMAN_DECODE_TABLE
from tamp_tpu_torch.engine import encode as tencode
from tamp_tpu_torch.engine.greedy import host_optimal_v1
from tamp_tpu_torch.ops.decode_wavefront import wavefront_decode_payload
from tools import torch_benchmark, torch_commit_kernel_bench, torch_profiler

ROOT = Path(__file__).resolve().parents[1]
native = pytest.mark.skipif(not _native.available(),
                            reason="the JAX package's native engine")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain kernels run many small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers (eight threads a worker stalled them ~100x beside five busy
    workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(n: int, seed: int, literal: int = 8) -> bytes:
    data = bench_torch.build_corpus(n, seed)
    if literal < 8:
        data = bytes(np.frombuffer(data, np.uint8) & ((1 << literal) - 1))
    return data


def test_measure_on_the_cpu_returns_its_keys():
    r = torch_commit_kernel_bench.measure(1 / 64, 1, scale=True,
                                          device="cpu")
    assert r["device"] == "cpu" and r["mb"] == 1 / 64
    for key in ("dispatch_ms", "decode_commit_raw_ms_per_mb",
                "decode_commit_ms_per_mb", "decode_commit_mb_s",
                "encode_commit_raw_ms_per_mb", "encode_commit_ms_per_mb",
                "encode_commit_mb_s", "scale_s1_ms", "scale_s8_ms",
                "scale_s8_vs_s1_aggregate"):
        assert r[key] > 0, key


def test_commit_kernel_bench_main_runs_at_a_tiny_size(capsys):
    import json

    assert torch_commit_kernel_bench.main([str(1 / 64), "1", "--device",
                                           "cpu"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["device"] == "cpu" and r["encode_commit_ms_per_mb"] > 0


def test_measure_checks_before_it_times(monkeypatch):
    from tamp_tpu_torch.ops import decode_wavefront

    real = decode_wavefront.decode_group

    def short(*a, **kw):
        outs, lens, errs = real(*a, **kw)
        return outs, lens - 1, errs
    monkeypatch.setattr(decode_wavefront, "decode_group", short)
    with pytest.raises(RuntimeError, match="decode commit"):
        torch_commit_kernel_bench.prepare(1 / 64, device="cpu")


def test_sweep_runs_at_a_tiny_size(monkeypatch, capsys):
    # windows 12 and 15 cost the plain tables ~10x w10's on the CPU
    monkeypatch.setattr(torch_benchmark, "WINDOWS", (8, 10))
    assert torch_benchmark.main(["--mb", str(4 / 1024), "--device",
                                 "cpu"]) == 0
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()[2:]]
    # two corpora x two windows x (native, card), and the container at w10
    assert len(rows) == 2 * (2 * 2 + 1)
    assert {r[1] for r in rows} == {"native", "card", "container"}
    # rates print with two decimals (a tiny CPU call may read 0.00)
    assert all(float(r[3]) >= 0 and float(r[4]) >= 0 and 0 < float(r[5]) < 2
               for r in rows)


@pytest.mark.parametrize("engine", torch_profiler.ENGINES)
def test_profiler_runs_at_a_tiny_size(engine, capsys):
    assert torch_profiler.main(["--engine", engine, "--mb", str(8 / 1024),
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cumulative" in out and "function calls" in out


def test_huffman_decode_table_equals_jax():
    assert len(HUFFMAN_DECODE_TABLE) == len(JAX_TABLE) == 256
    for k in range(256):
        assert HUFFMAN_DECODE_TABLE[k] == JAX_TABLE[k], k


@pytest.mark.parametrize("window,extended,mode", [
    (8, True, "commit"), (10, True, "chase"), (10, False, "xla"),
    (15, True, None)])
def test_wavefront_decode_payload_equals_jax(window, extended, mode):
    import tamp_tpu

    data = _text(6000, window)
    stream = tamp_tpu.compress(data, window=window, extended=extended)
    di = dictionary_array(1 << window, literal=8)
    kw = dict(window=window, literal=8, extended=extended, more=False,
              dict_init=di, max_out=len(data))
    want = jax_payload(stream[1:], **kw)
    assert want == data
    assert wavefront_decode_payload(stream[1:], device="cpu", mode=mode,
                                    **kw) == want


@native
@pytest.mark.parametrize("window,literal,custom", [
    (8, 8, False), (10, 8, False), (12, 6, False), (10, 7, True)])
def test_encodes_equal_jax(window, literal, custom):
    data = _text(6000, window + literal, literal)
    dictionary = None
    if custom:
        dictionary = bytes(np.random.default_rng(1).integers(
            0, 1 << literal, 1 << window).astype(np.uint8))
    kw = dict(window=window, literal=literal, dictionary=dictionary)
    opt = jencode.encode_v1(data, parse="optimal", **kw)
    assert tencode.encode_v1(data, parse="optimal", device="cpu",
                             **kw) == opt
    assert host_optimal_v1(data, **kw) == opt
    for lazy in (False, True):
        assert tencode.encode_v1(data, lazy_matching=lazy, device="cpu",
                                 **kw) == jencode.encode_v1(
            data, lazy_matching=lazy, **kw)
    assert tencode.encode_extended_optimal(data, device="cpu", **kw) == \
        jencode.encode_extended_optimal(data, **kw)


def test_encode_v1_refuses_what_jax_refuses_and_a_search_fn():
    from tamp_tpu_torch.exceptions import ExcessBitsError

    for fn in (jencode.encode_v1,
               lambda d, **kw: tencode.encode_v1(d, device="cpu", **kw)):
        with pytest.raises(ValueError, match="unknown parse"):
            fn(b"abc", parse="fast")
    with pytest.raises(ValueError, match="search_fn"):
        tencode.encode_v1(b"abc", search_fn=lambda *a, **k: None,
                          device="cpu")
    with pytest.raises(ExcessBitsError):
        host_optimal_v1(bytes([200, 201]), literal=7)


@native
@pytest.mark.parametrize("name", [None, "native", "ENGINE", "python"])
def test_get_compress_implementation_equals_jax(name):
    for kw in (dict(window=10, literal=8, extended=True, lazy_matching=False),
               dict(window=9, literal=8, extended=False, lazy_matching=True),
               dict(window=8, literal=7, extended=True, lazy_matching=True)):
        d = _text(5000, 4, kw["literal"])
        want = jcli.get_compress_implementation(name)(d, **kw)
        got = tcli.get_compress_implementation(name)(
            d, device="cpu" if name == "ENGINE" else None, **kw)
        assert got == want, kw


@native
@pytest.mark.parametrize("name", [None, "native", "Python"])
def test_get_decompress_implementation_equals_jax(name):
    import tamp_tpu

    for window, extended in ((10, True), (8, False)):
        data = _text(5000, window)
        stream = tamp_tpu.compress(data, window=window, extended=extended)
        assert tcli.get_decompress_implementation(name)(stream) == \
            jcli.get_decompress_implementation(name)(stream) == data


def test_unknown_implementations_exit_as_in_jax():
    for get in ("get_compress_implementation",
                "get_decompress_implementation"):
        with pytest.raises(SystemExit) as want:
            getattr(jcli, get)("fortran")
        with pytest.raises(SystemExit) as got:
            getattr(tcli, get)("fortran")
        assert str(got.value) == str(want.value)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_bench_and_tools_import_no_jax_and_nothing_of_tamp_tpu():
    files = [ROOT / "bench_torch.py",
             *sorted((ROOT / "tools").glob("torch_*.py"))]
    assert len(files) >= 4
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "tamp_tpu"), \
                (f, name)
    code = ("import sys, bench_torch, tools.torch_commit_kernel_bench, "
            "tools.torch_benchmark, tools.torch_profiler; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tamp_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
