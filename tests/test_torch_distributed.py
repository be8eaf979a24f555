"""The port's compress_distributed (tamp_tpu_torch.parallel.distributed) in
a gloo world of two child processes on the CPU: rank 0's container
byte-equal to the port's single-process compress_sharded and to the JAX
package's containers (engine="device-commit" to its "device-commit",
engine="device" to its "tables", the pairing of the port's single-process
tests, and the JAX engine names "native" and "tables" to the JAX
containers of those names), decodable by the JAX package; every other rank
returns None; errors raise on every rank."""

import json

import numpy as np
import pytest
import torch.distributed as dist

from tamp_tpu import _native
from tamp_tpu.parallel import shard as jshard
from tamp_tpu_torch.parallel import shard as tshard
from tamp_tpu_torch.parallel.distributed import compress_distributed
from torch_world import spawn, wait

SHARD = 4096
# name, input size (5 shards with a short last one, or 1 shard: rank 1
# then owns none), options, the JAX package's engine for the same container
CASES = (
    ("commit, 5 shards", 4 * SHARD + 1500, {"engine": "device-commit"},
     "device-commit"),
    ("commit, 1 shard", 3000, {"engine": "device-commit"}, "device-commit"),
    ("commit v1, 5 shards", 4 * SHARD + 1500,
     {"engine": "device-commit", "extended": False}, "device-commit"),
    ("device, 5 shards", 4 * SHARD + 1500, {"engine": "device"}, "tables"),
    ("device, 1 shard", 3000, {"engine": "device"}, "tables"),
)

CHILD = """
import json, os
from tamp_tpu_torch.exceptions import ExcessBitsError
from tamp_tpu_torch.parallel.distributed import compress_distributed

spec = json.load(open(os.path.join(TMP, "spec.json")))
res = {}
for i, (name, kw) in enumerate(spec["cases"]):
    data = open(os.path.join(TMP, f"in{i}.bin"), "rb").read()
    blob = compress_distributed(data, shard_size=spec["shard"],
                                device="cpu", **kw)
    if RANK == 0:
        open(os.path.join(TMP, f"out{i}.ttpu"), "wb").write(blob)
    res[name] = blob is None
data = open(os.path.join(TMP, "in0.bin"), "rb").read()
for engine in ("native", "tables"):  # the JAX engine names, on the card
    blob = compress_distributed(data, engine=engine,
                                shard_size=spec["shard"], device="cpu")
    if RANK == 0:
        open(os.path.join(TMP, f"{engine}.ttpu"), "wb").write(blob)
    res[engine] = blob is None
excess = open(os.path.join(TMP, "excess.bin"), "rb").read()
try:  # a byte of 0x80 in shard 1, which rank 1 encodes, at literal 7
    compress_distributed(excess, literal=7, shard_size=spec["shard"],
                         device="cpu")
    res["excess"] = "returned"
except ExcessBitsError:
    res["excess"] = "ExcessBitsError"
json.dump(res, open(os.path.join(TMP, f"rank{RANK}.json"), "w"))
"""


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)))
             for _ in range(96)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 96, n))
    return text[: n // 2] + b"=" * 400 + text[n // 2 : n - 400]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank 0's containers by case, each rank's other results, inputs)."""
    tmp = tmp_path_factory.mktemp("world2")
    datas = [_text(size, 30 + i) for i, (_n, size, _kw, _e) in
             enumerate(CASES)]
    for i, data in enumerate(datas):
        (tmp / f"in{i}.bin").write_bytes(data)
    excess = bytearray(_text(2 * SHARD, 40))
    excess[SHARD + 100] = 0x80
    (tmp / "excess.bin").write_bytes(bytes(excess))
    (tmp / "spec.json").write_text(json.dumps({
        "cases": [(name, kw) for name, _s, kw, _e in CASES],
        "shard": SHARD}))
    wait(spawn(CHILD, 2, tmp))
    blobs = {name: (tmp / f"out{i}.ttpu").read_bytes()
             for i, (name, _s, _kw, _e) in enumerate(CASES)}
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(2)]
    for engine in ("native", "tables"):
        blobs[engine] = (tmp / f"{engine}.ttpu").read_bytes()
    return blobs, ranks, dict(zip((c[0] for c in CASES), datas))


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
@pytest.mark.parametrize("name,size,kw,jax_engine", CASES,
                         ids=[c[0] for c in CASES])
def test_container_equals_single_process_and_jax(world, name, size, kw,
                                                 jax_engine):
    blobs, _ranks, datas = world
    blob, data = blobs[name], datas[name]
    assert len(data) == size
    assert blob == tshard.compress_sharded(data, shard_size=SHARD,
                                           device="cpu", **kw)
    jkw = {k: v for k, v in kw.items() if k != "engine"}
    assert blob == jshard.compress_sharded(data, shard_size=SHARD,
                                           engine=jax_engine, **jkw)
    assert bytes(jshard.decompress_sharded(blob)) == data


def test_other_ranks_return_none(world):
    _blobs, ranks, _d = world
    for name, _s, _kw, _e in CASES:
        assert ranks[0][name] is False and ranks[1][name] is True, name


@pytest.mark.skipif(not _native.available(), reason="native engine needed")
@pytest.mark.parametrize("engine", ["native", "tables"])
def test_host_engines_raise_on_every_rank(world, engine):
    # the JAX engine names are routes on the card: rank 0's container is
    # the JAX package's for that name, and rank 1 returns None
    blobs, ranks, datas = world
    data = datas[CASES[0][0]]
    assert [r[engine] for r in ranks] == [False, True]
    assert blobs[engine] == jshard.compress_sharded(
        data, shard_size=SHARD, engine=engine)
    assert blobs[engine] == tshard.compress_sharded(
        data, shard_size=SHARD, engine=engine, device="cpu")


def test_excess_bits_raise_on_every_rank(world):
    _blobs, ranks, _d = world
    assert [r["excess"] for r in ranks] == ["ExcessBitsError"] * 2


def test_single_process_call_is_compress_sharded():
    assert not dist.is_initialized()  # no world in the test process
    data = _text(2 * SHARD + 700, 50)
    assert compress_distributed(data, shard_size=SHARD, device="cpu",
                                engine="device-commit") == \
        tshard.compress_sharded(data, shard_size=SHARD, device="cpu",
                                engine="device-commit")
