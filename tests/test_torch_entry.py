"""The port's entry points (tamp_tpu_torch.entry) on the CPU against
the JAX package's ``__graft_entry__``: ``entry()``'s six tables element by
element, the dry run's five encode legs byte by byte against the JAX
package's host references, and ``dryrun_multichip`` to its end in worlds of
1 and 2 processes (gloo, child processes: no process group outlives a
test in the pytest worker)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import tamp_tpu
from tamp_tpu import _native
from tamp_tpu.engine.encode import encode_extended_optimal, encode_v1
from tamp_tpu_torch import entry as tentry
from test_torch_pipeline_ext import native_planned
from torch_world import ROOT, TAIL, _free_port, spawn, wait

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine needed")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op thread
    runs them about as fast here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_tables_equal_mxu_chunk():
    fn, args = tentry.entry(device="cpu")
    assert [a.device.type for a in args] == ["cpu"] * 3
    got = fn(*args)
    jfn, jargs = graft.entry()
    want = jax.jit(jfn)(*jargs)
    assert len(got) == len(want) == 6
    for name, g, w in zip(("len15", "idx15", "len16", "idx16", "plen",
                           "pidx"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and g.shape == w.shape == (256,), name
        assert np.array_equal(g.numpy(), w), name
    # no state between calls
    assert all(torch.equal(a, b) for a, b in zip(fn(*args), got))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError):
        tentry.entry()
    with pytest.raises(RuntimeError):
        tentry.dryrun_multichip(1)
    with pytest.raises(ValueError):
        tentry.dryrun_multichip(0, device="cpu")


def _jax_rows(n: int):
    """The JAX dry run's rows and run-heavy mix (__graft_entry__.py:56-101)."""
    data = np.random.default_rng(1).integers(97, 123, (n, 8192),
                                             dtype=np.uint8)
    mix = []
    for i in range(n):
        row = bytearray(data[i].tobytes())
        row[200:500] = bytes([65 + i]) * 300
        row[4000:4100] = row[100:200] * 1
        mix.append(bytes(row))
    return data, mix


def test_dryrun_encodes_equal_the_jax_references():
    data, mix = _jax_rows(2)
    assert tentry.run_heavy_mix(data) == mix
    shards = [bytes(r) for r in data]
    out = tentry.dryrun_encodes(shards, mix, device="cpu")
    assert out["v1"] == [tamp_tpu.compress(s, window=8, extended=False,
                                           lazy_matching=False)
                         for s in shards]
    assert out["extended"] == [native_planned(m, 10, 8) for m in mix]
    assert out["greedy"] == [tamp_tpu.compress(m, window=10, literal=8,
                                               extended=True)
                             for m in mix]
    assert out["v1 optimal"] == [encode_v1(m, window=10, literal=8,
                                           parse="optimal") for m in mix]
    assert out["extended optimal"] == [
        encode_extended_optimal(m, window=10, literal=8) for m in mix]


@pytest.mark.parametrize("seed", [0, 3])
def test_planned_reference_equals_the_native_planned_committer(seed):
    # seed 0: no run of 9 bytes, so an empty plan, which table_compress
    # commits unplanned unless forced (force_planned=False: the stream
    # differs from byte 1491, 5191 bytes against 5190)
    rng = np.random.default_rng(seed)
    n, window = int(rng.integers(0, 9000)), int(rng.integers(8, 13))
    data = bytes(rng.integers(97, 97 + int(rng.integers(2, 27)), n)
                 .astype(np.uint8))
    if seed:
        data = data[:999] + b"q" * 40 + data[999:]
    assert tentry.planned_reference(data, window, 8) == native_planned(
        data, window, 8)


DRYRUN = """
import contextlib, io, os
from tamp_tpu_torch.entry import dryrun_multichip
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dryrun_multichip({n}, device="cpu")
open(os.path.join(TMP, f"rank{{RANK}}.txt"), "w").write(buf.getvalue())
"""


def test_dryrun_in_place_in_a_world_of_two(tmp_path):
    wait(spawn(DRYRUN.format(n=2), 2, tmp_path))
    assert (tmp_path / "rank0.txt").read_text().startswith(
        "dryrun_multichip ok: 2 devices")
    assert (tmp_path / "rank1.txt").read_text() == ""  # rank 0 reports


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_from_a_process_without_a_world(tmp_path, n):
    # n = 1 runs in the child, in make_mesh's world of one; n = 2 starts
    # its own two ranks
    wait(spawn(DRYRUN.format(n=n) + """
import torch.distributed as dist
assert not dist.is_initialized()  # the world of one is destroyed
""", 1, tmp_path))
    if n == 1:
        assert (tmp_path / "rank0.txt").read_text().startswith(
            "dryrun_multichip ok: 1 devices")


def test_dryrun_refuses_a_world_of_another_size(tmp_path):
    wait(spawn("""
from tamp_tpu_torch.entry import dryrun_multichip
try:
    dryrun_multichip(3, device="cpu")
except ValueError:
    pass
else:
    raise SystemExit("a world of 2 ran a dry run of 3")
""", 2, tmp_path))



def test_dryrun_in_place_under_torchrun(tmp_path):
    """Each rank of a launcher (torchrun: WORLD_SIZE, RANK and the master's
    address in the environment) joins that world and leaves it."""
    script = tmp_path / "rank.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch.distributed as dist
from tamp_tpu_torch.entry import dryrun_multichip
dryrun_multichip(2, device="cpu")
assert not dist.is_initialized()
""" + TAIL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), str(script)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dryrun_multichip ok: 2 devices" in r.stdout
