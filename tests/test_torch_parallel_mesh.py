"""The port's mesh steps (tamp_tpu_torch.parallel.shard: make_mesh,
sharded_search_step, sharded_decode_step) in gloo worlds of 1 and 2 child
processes on the CPU, against the JAX steps on the virtual CPU mesh of the
same size (conftest) and the NumPy oracle: tables element-equal, the cost
estimate within rel 1e-5 (the sums run in other orders), decoded bytes,
lengths and totals equal; errors raised on every rank."""

import json

import numpy as np
import pytest

import tamp_tpu
from tamp_tpu.constants import HUFFMAN_CODES, HUFFMAN_LENGTHS
from tamp_tpu.dictionary import dictionary_array
from tamp_tpu.engine.search_np import match_tables
from tamp_tpu.parallel import shard as jshard
from torch_world import spawn, wait

WORLDS = (1, 2)
# search cases: name, window, literal, (S, L)
SEARCH = (("w8", 8, 8, (4, 256)), ("w10", 10, 8, (2, 2048)))
# decode cases: name, compress options; 4 streams of 300 bytes at w9
DECODE = (("extended", {}), ("v1", {"extended": False}))
N_STREAMS, MAX_OUT = 4, 512
MODES = ("commit", "xla")

CHILD = """
import json, os
import numpy as np
from tamp_tpu_torch.parallel.distributed import global_mesh
from tamp_tpu_torch.parallel.shard import (
    make_mesh, sharded_decode_step, sharded_search_step,
)

spec = json.load(open(os.path.join(TMP, "spec.json")))
inp = np.load(os.path.join(TMP, "inputs.npz"))
res = {}


def raises(fn):
    try:
        fn()
    except ValueError:
        return 1
    return 0


res["mesh_size"] = raises(lambda: make_mesh(WORLD + 1, device="cpu"))
mesh = make_mesh(WORLD, device="cpu")
gm = global_mesh(device="cpu")
res["global_mesh"] = [gm.size(), gm.get_local_rank(), gm.mesh_dim_names[0]
                      == "dp", mesh.get_local_rank()]
for name, w, l in spec["search"]:
    out = sharded_search_step(mesh, inp[name], w, l)
    res[name + "/len16"] = out["len16"].numpy()
    res[name + "/idx16"] = out["idx16"].numpy()
    res[name + "/est"] = out["est_bits_total"].numpy()


def streams(name):
    return [inp[f"{name}/{i}"].tobytes() for i in range(spec["n_streams"])]


res["corrupt"] = raises(lambda: sharded_decode_step(
    mesh, streams("corrupt"), max_out=spec["max_out"]))
if WORLD > 1:  # WORLD + 1 rows divide over no larger world
    res["indivisible"] = raises(lambda: sharded_search_step(
        mesh, inp["w8"][: WORLD + 1], 8, 8))
    res["indivisible_decode"] = raises(lambda: sharded_decode_step(
        mesh, streams("extended")[: WORLD + 1], max_out=spec["max_out"]))
for name in spec["decode"]:
    for mode in spec["modes"]:
        os.environ["TAMP_TPU_DECODE"] = mode
        outs, lens, total = sharded_decode_step(mesh, streams(name),
                                                max_out=spec["max_out"])
        res[f"{name}/{mode}/outs"] = outs.numpy()
        res[f"{name}/{mode}/lens"] = lens.numpy()
        res[f"{name}/{mode}/total"] = total.numpy()
np.savez(os.path.join(TMP, f"rank{RANK}.npz"), **res)
"""


def _jax_mesh(n: int):
    """The JAX package's mesh of ``n`` virtual CPU devices.  Its
    ``make_mesh`` sets the CPU device count to ``n`` when the backend has
    not started yet: start it first, with the conftest's 8 devices."""
    import jax

    jax.devices()
    return jshard.make_mesh(n)


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 8)))
             for _ in range(48)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 48, n))[:n]


def _oob_stream(header: int) -> bytes:
    """A w9 stream under ``header`` whose second token is a basic match of
    13 bytes at slot 508, past the window end (an out-of-bounds read)."""
    bits = "1" + format(0x41, "08b")  # a literal
    # a match of size minp + 11 = 13 bytes, then its 9-bit slot
    bits += format(HUFFMAN_CODES[11], f"0{HUFFMAN_LENGTHS[11]}b")
    bits += format(508, "09b")
    bits += "0" * (-len(bits) % 8)
    return bytes([header]) + int(bits, 2).to_bytes(len(bits) // 8, "big")


def _inputs():
    arrays = {}
    rng = np.random.default_rng(7)
    arrays["w8"] = rng.integers(97, 123, (4, 256), dtype=np.uint8)
    arrays["w10"] = np.frombuffer(_text(2 * 2048, 8), np.uint8).reshape(
        2, 2048).copy()
    datas = [_text(300, 20 + i) for i in range(N_STREAMS)]
    streams = {}
    for name, kw in DECODE:
        streams[name] = [tamp_tpu.compress(d, window=9, **kw) for d in datas]
    streams["corrupt"] = list(streams["extended"])
    streams["corrupt"][-1] = _oob_stream(streams["extended"][0][0])
    for name, ss in streams.items():
        for i, s in enumerate(ss):
            arrays[f"{name}/{i}"] = np.frombuffer(s, np.uint8)
    return arrays, datas, streams


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' results, by world size; and the inputs."""
    arrays, datas, streams = _inputs()
    runs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        np.savez(tmp / "inputs.npz", **arrays)
        (tmp / "spec.json").write_text(json.dumps({
            "search": [c[:3] for c in SEARCH],
            "decode": [name for name, _kw in DECODE], "modes": MODES,
            "n_streams": N_STREAMS, "max_out": MAX_OUT}))
        runs[world] = (tmp, spawn(CHILD, world, tmp))
    for tmp, procs in runs.values():
        wait(procs)
    results = {world: [dict(np.load(tmp / f"rank{r}.npz"))
                       for r in range(world)]
               for world, (tmp, _procs) in runs.items()}
    return results, arrays, datas, streams


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,w,l,shape", SEARCH)
def test_search_step_matches_jax_and_oracle(worlds, world, name, w, l,
                                            shape):
    results, arrays, _d, _s = worlds
    data = arrays[name]
    assert data.shape == shape
    want = jshard.sharded_search_step(_jax_mesh(world), data, w, l)
    jl, ji = np.asarray(want["len16"]), np.asarray(want["idx16"])
    jest = float(np.asarray(want["est_bits_total"]).reshape(-1)[0])
    d = dictionary_array(1 << w, literal=l)
    for res in results[world]:  # every rank returns the whole result
        np.testing.assert_array_equal(res[name + "/len16"], jl)
        np.testing.assert_array_equal(res[name + "/idx16"], ji)
        assert res[name + "/est"].shape == ()
        assert float(res[name + "/est"]) == pytest.approx(jest, rel=1e-5)
        for s in range(shape[0]):
            tables = match_tables(data[s], d, w)
            np.testing.assert_array_equal(res[name + "/len16"][s],
                                          tables.len16)
            np.testing.assert_array_equal(res[name + "/idx16"][s],
                                          tables.idx16)


@pytest.fixture(scope="module")
def jax_decode(worlds):
    """The JAX decode step's (outs, lens, total) by (world, stream set),
    computed once for both of the port's modes."""
    _r, _a, _d, streams = worlds
    done = {}

    def get(world, name):
        if (world, name) not in done:
            outs, lens, total = jshard.sharded_decode_step(
                _jax_mesh(world), streams[name], max_out=MAX_OUT)
            done[world, name] = (np.asarray(outs), np.asarray(lens),
                                 int(np.asarray(total).reshape(-1)[0]))
        return done[world, name]
    return get


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [name for name, _kw in DECODE])
@pytest.mark.parametrize("mode", MODES)
def test_decode_step_matches_jax(worlds, jax_decode, world, name, mode):
    results, _a, datas, _s = worlds
    jouts, jlens, jtotal = jax_decode(world, name)
    assert jtotal == sum(len(d) for d in datas)
    for res in results[world]:
        outs = res[f"{name}/{mode}/outs"]
        lens = res[f"{name}/{mode}/lens"]
        assert outs.shape == (N_STREAMS, 1024)  # MAX_OUT's bucket
        np.testing.assert_array_equal(lens, jlens)
        assert int(res[f"{name}/{mode}/total"]) == jtotal
        for i, d in enumerate(datas):
            assert outs[i, : lens[i]].tobytes() == d
            assert outs[i, : lens[i]].tobytes() == \
                jouts[i, : jlens[i]].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_corrupt_stream_raises_on_every_rank(worlds, world):
    results, _a, _d, streams = worlds
    with pytest.raises(ValueError):
        jshard.sharded_decode_step(_jax_mesh(world),
                                   streams["corrupt"], max_out=MAX_OUT)
    # the bad stream is on the last rank; every rank raised, and all went
    # on to the decode cases after it
    assert [int(res["corrupt"]) for res in results[world]] == [1] * world


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_of_another_size_raises_on_every_rank(worlds, world):
    results, _a, _d, _s = worlds
    assert [int(res["mesh_size"]) for res in results[world]] == [1] * world


@pytest.mark.parametrize("world", WORLDS)
def test_meshes_span_the_world(worlds, world):
    results, _a, _d, _s = worlds
    assert [res["global_mesh"].tolist() for res in results[world]] == [
        [world, r, 1, r] for r in range(world)]


@pytest.mark.parametrize("step", ["indivisible", "indivisible_decode"])
def test_indivisible_shards_raise_on_every_rank(worlds, step):
    results, _a, _d, _s = worlds
    assert [int(res[step]) for res in results[2]] == [1, 1]
