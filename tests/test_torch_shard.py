"""The port's TTPU entry points (tamp_tpu_torch.parallel.shard) against the
JAX package, both directions, plus the port's isolation from JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.parallel import shard as tshard

ROOT = Path(__file__).resolve().parent.parent


def _corpus(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 10)))
             for _ in range(128)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 128, n))
    return text[: n // 2] + b"-" * 700 + text[n // 2 : n]


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
def test_container_matches_jax_and_cross_decodes():
    data = _corpus(9000, 1)
    blob = tshard.compress_sharded(data, shard_size=3000, device="cpu",
                                   engine="device-commit")
    assert blob == jshard.compress_sharded(data, shard_size=3000,
                                           engine="device-commit")
    # port container -> JAX package's decoder
    assert bytes(jshard.decompress_sharded(blob)) == data
    # port round trip
    assert bytes(tshard.decompress_sharded_device(blob, device="cpu")) == data
    # JAX package native-engine container -> port decoder
    nat = jshard.compress_sharded(data, engine="native", shard_size=4000)
    assert bytes(tshard.decompress_sharded_device(nat, device="cpu")) == data


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
def test_file_path_device_greedy_equals_compress_sharded(tmp_path):
    # the CLI's file-to-file --sharded route: the reference greedy streams
    # (the JAX CLI's engine="native" container), batch by batch
    data = _corpus(6000, 4)
    src = tmp_path / "raw.bin"
    src.write_bytes(data)
    for kw in ({}, {"lazy_matching": True, "window": 9}):
        want = tshard.compress_sharded(data, shard_size=700,
                                       engine="device-greedy", device="cpu",
                                       **kw)
        assert want == jshard.compress_sharded(data, shard_size=700,
                                               engine="native", **kw)
        for workers in (1, 3):  # batches of 2 and of 6 shards
            dst = tmp_path / f"out{workers}.ttpu"
            n = tshard.compress_file_sharded(
                src, dst, shard_size=700, workers=workers,
                engine="device-greedy", device="cpu", **kw)
            assert n == len(want) and dst.read_bytes() == want


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
def test_container_custom_dictionary_and_empty():
    rng = np.random.default_rng(2)
    dictionary = bytes(rng.integers(97, 123, 1024).astype(np.uint8))
    data = dictionary[:2500] * 2 + _corpus(800, 3)
    blob = tshard.compress_sharded(data, shard_size=2048,
                                   dictionary=dictionary, device="cpu",
                                   engine="device-commit")
    assert blob == jshard.compress_sharded(
        data, shard_size=2048, dictionary=dictionary, engine="device-commit")
    assert bytes(tshard.decompress_sharded_device(
        blob, dictionary=dictionary, device="cpu")) == data
    empty = tshard.compress_sharded(b"", device="cpu", engine="device-commit")
    assert empty == jshard.compress_sharded(b"", engine="device-commit")
    assert bytes(tshard.decompress_sharded_device(empty, device="cpu")) == b""


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError):
        tshard.compress_sharded(b"abc", engine="device-commit")
    blob = tshard.compress_sharded(b"abc", device="cpu",
                                   engine="device-commit")
    with pytest.raises(RuntimeError):
        tshard.decompress_sharded_device(blob)


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
@pytest.mark.parametrize("kw", [
    {"extended": False}, {"extended": False, "lazy_matching": True},
    {"lazy_matching": True}, {"extended": False, "window": 11, "literal": 5},
])
def test_v1_and_lazy_containers_match_jax(kw):
    lmask = (1 << kw.get("literal", 8)) - 1
    data = bytes(b & lmask for b in _corpus(7000, 4))
    blob = tshard.compress_sharded(data, shard_size=2500, device="cpu",
                                   engine="device-commit", **kw)
    assert blob == jshard.compress_sharded(data, shard_size=2500,
                                           engine="device-commit", **kw)
    assert bytes(jshard.decompress_sharded(blob)) == data
    assert bytes(tshard.decompress_sharded_device(blob, device="cpu")) == data


def test_v1_container_custom_dictionary():
    rng = np.random.default_rng(5)
    dictionary = bytes(rng.integers(97, 123, 1024).astype(np.uint8))
    data = dictionary[:1800] + _corpus(900, 6)
    for lazy in (False, True):
        blob = tshard.compress_sharded(data, shard_size=1500, extended=False,
                                       lazy_matching=lazy,
                                       dictionary=dictionary, device="cpu",
                                       engine="device-commit")
        assert blob == jshard.compress_sharded(
            data, shard_size=1500, extended=False, lazy_matching=lazy,
            dictionary=dictionary, engine="device-commit")
        assert bytes(tshard.decompress_sharded_device(
            blob, dictionary=dictionary, device="cpu")) == data


def test_not_ported_modes_raise():
    # the JAX package's engine names are routes on the card, each writing
    # that name's JAX container; an unknown name is a ValueError
    data = _corpus(3000, 9)
    for kw in ({"engine": "native"}, {"engine": "tables"}):
        assert tshard.compress_sharded(
            data, shard_size=1024, device="cpu", **kw) == \
            jshard.compress_sharded(data, shard_size=1024, **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        tshard.compress_sharded(b"abc", engine="bogus", device="cpu")
    blob = tshard.compress_sharded(b"abc", engine="device", device="cpu")
    assert bytes(tshard.decompress_sharded_device(blob, device="cpu")) \
        == b"abc"
    # every decode algorithm is ported: an unknown one is a ValueError, as
    # in the JAX package
    blob = tshard.compress_sharded(b"abc", device="cpu",
                                   engine="device-commit")
    for algorithm in ("wavefront", "serial"):
        assert bytes(tshard.decompress_sharded_device(
            blob, algorithm=algorithm, device="cpu")) == b"abc"
    with pytest.raises(ValueError):
        tshard.decompress_sharded_device(blob, algorithm="bogus",
                                         device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_tamp_tpu():
    files = sorted((ROOT / "tamp_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tamp_tpu"), (f, name)
    code = ("import sys, tamp_tpu_torch, tamp_tpu_torch.parallel.shard, "
            "tamp_tpu_torch.parallel.distributed, tamp_tpu_torch.entry, "
            "tamp_tpu_torch.engine.pipeline_ext, "
            "tamp_tpu_torch.engine.pipeline, "
            "tamp_tpu_torch.engine.greedy, "
            "tamp_tpu_torch.ops.greedy_predict, "
            "tamp_tpu_torch.ops.decode_wavefront, "
            "tamp_tpu_torch.ops.decode_serial, "
            "tamp_tpu_torch.cli.main, tamp_tpu_torch.dictbuild, "
            "tamp_tpu_torch.engine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tamp_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
