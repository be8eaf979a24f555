"""Kernels X3 and X4 of the port on the CPU (their plain versions, through
the wrappers' CPU route) against the JAX package's optimal DPs
(``ops/opt_parse.opt_v1_choice_device``, ``ops/opt_parse_ext.
opt_ext_choice_device``) element for element, and the host half of the
optimal extended encode (forced-RLE regions, khat-aware tables, choice
walk) against the JAX package's ``engine/encode`` and native engine.

The inputs are seeded hazard shards (``hazard_opt_shards`` of
tests/test_torch_cuda.py, which also feeds the card's tests): sizes around
the blocks and the lookback K, all-equal bytes, long periodic matches,
forced-RLE chunk splits of 241 and 240, and an unencodable literal.
X3's plain version also runs with its kernel's grouped combine at ragged
group counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tamp_tpu import _native
from tamp_tpu.engine import encode as jencode
from tamp_tpu.ops.opt_parse import opt_v1_choice_device
from tamp_tpu.ops.opt_parse_ext import opt_ext_choice_device
from tamp_tpu_torch.constants import compute_min_pattern_size
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine import encode as tencode
from tamp_tpu_torch.engine.greedy import host_v1_tables, opt_ext_walk
from tamp_tpu_torch.ops.opt_parse import (
    B_V1, G_V1, INF, combine_plain, opt_v1_choice, opt_v1_choice_plain,
)
from tamp_tpu_torch.ops.opt_parse_ext import (
    opt_ext_choice, opt_ext_choice_plain,
)

from test_torch_cuda import ext_opt_inputs, hazard_opt_shards, v1_opt_inputs

needs_native = pytest.mark.skipif(not _native.available(),
                                  reason="native engine needed")
CASES = [(8, 8), (10, 8), (11, 6), (12, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain DPs run thousands of small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax_x3(args, window, literal):
    flen, data, npos = args
    return [np.asarray(x) for x in opt_v1_choice_device(
        jnp.asarray(flen), jnp.asarray(data), jnp.asarray(npos),
        window=window, literal=literal, NP=flen.shape[1])]


def _jax_x4(args, window, literal):
    packed, data, npos, sbp, sbc = args
    db = packed if data is None else data.astype(np.int32)
    return [np.asarray(x) for x in opt_ext_choice_device(
        jnp.asarray(packed), jnp.asarray(db), jnp.asarray(npos),
        jnp.asarray(sbp), jnp.asarray(sbc), window=window, literal=literal,
        NP=packed.shape[1], need_data=literal < 8)]


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("window,literal", CASES)
def test_x3_plain_equals_jax(window, literal):
    shards = hazard_opt_shards(window, window, literal)
    args = v1_opt_inputs(shards, window, literal)
    want = _jax_x3(args, window, literal)
    _equal(opt_v1_choice(*_t(args), window=window, literal=literal), want)
    choice = want[0]
    # matches at the table cap occur, and only the unencodable shard is bad
    assert (choice == min(16, compute_min_pattern_size(window, literal)
                          + 13)).any()
    assert list(want[2]) == [False] * 12 + [True] * (literal < 8)


@needs_native
@pytest.mark.parametrize("window,literal", CASES)
def test_x4_plain_equals_jax(window, literal):
    shards = hazard_opt_shards(window, window, literal)
    args = ext_opt_inputs(shards, window, literal)
    want = _jax_x4(args, window, literal)
    _equal(opt_ext_choice(*_t(args), window=window, literal=literal), want)
    minp = compute_min_pattern_size(window, literal)
    npos = args[2]
    # the periodic shard takes extended matches, some cut by the ring end
    # below the cap; the run shard has forced regions (interior positions)
    periodic = want[0][10, : npos[10]]
    assert periodic.max() == minp + 131
    assert ((periodic > minp + 11) & (periodic < minp + 131)).any()
    assert (args[0][11] < 0).sum() > 1000
    assert list(want[2]) == [False] * 12 + [True] * (literal < 8)


@needs_native
@pytest.mark.parametrize("x", ["X3", "X4"])
def test_plain_is_independent_of_the_block_size(x):
    window, literal = 10, 8
    shards = hazard_opt_shards(1, window, literal)
    if x == "X3":
        args = _t(v1_opt_inputs(shards, window, literal))
        runs = [opt_v1_choice_plain(*args, window=window, literal=literal,
                                    B=B) for B in (256, 1024)]
    else:
        args = _t(ext_opt_inputs(shards, window, literal))
        runs = [opt_ext_choice_plain(*args, window=window, literal=literal,
                                     B=B) for B in (256, 1024)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_b,group", [(1, G_V1), (5, G_V1), (33, G_V1),
                                       (40, G_V1), (64, 5), (9, 1)])
def test_grouped_combine_equals_serial(n_b, group):
    """combine_plain's two-level form (X3's kernel combine) against its
    serial walk on seeded matrices with saturated entries: n_b = 1, fewer
    blocks than a group, ragged last groups, groups of one."""
    rng = np.random.default_rng(n_b)
    T = rng.integers(0, 60, (3, n_b, 16, 16))
    T[rng.random(T.shape) < 0.3] = INF
    T[0, :, 3] = INF  # a row with no edge: its costs saturate
    T = torch.from_numpy(T.astype(np.int32))
    serial = combine_plain(T)
    for g, w in zip(combine_plain(T, group), serial):
        assert torch.equal(g, w)
    assert int(serial[1][0, 3]) == INF


@pytest.mark.parametrize("window,literal", [(10, 8), (11, 6)])
@pytest.mark.parametrize("B,group", [(16, 7), (64, 5), (256, G_V1),
                                     (B_V1, G_V1), (4096, G_V1)])
def test_x3_plain_grouped_equals_jax(window, literal, B, group):
    """X3's plain version with the kernel's grouped combine against the JAX
    DP on the hazard shards (NP = 4096): n_b = 256 and 64 in ragged groups,
    16 and 4096 / B_V1 blocks in one short group, and one block."""
    args = v1_opt_inputs(hazard_opt_shards(window, window, literal), window,
                         literal)
    assert args[0].shape[1] == 4096
    want = _jax_x3(args, window, literal)
    _equal(opt_v1_choice_plain(*_t(args), window=window, literal=literal,
                               B=B, group=group), want)
    assert bool(want[2].any()) == (literal < 8)


@needs_native
@pytest.mark.parametrize("window,literal", [(10, 8), (11, 6)])
@pytest.mark.parametrize("x,B,group", [("X3", 16, None), ("X3", 16, 4),
                                       ("X4", 64, None)])
def test_plain_rebase_keeps_costs_below_inf(monkeypatch, window, literal, x,
                                            B, group):
    """The combine's rebase (each boundary vector less its least entry)
    with INF lowered to 2^11: the hazard shards cost up to ~3x that, and
    the plain DPs still give the JAX DP's choice and ``bad`` (with the real
    INF), and its cost0 saturated at the lowered INF."""
    from tamp_tpu_torch.ops import opt_parse, opt_parse_ext

    low = 1 << 11
    shards = hazard_opt_shards(window, window, literal)
    if x == "X3":
        args = v1_opt_inputs(shards, window, literal)
        want = _jax_x3(args, window, literal)
    else:
        args = ext_opt_inputs(shards, window, literal)
        want = _jax_x4(args, window, literal)
    assert (want[1][~want[2]] > low).sum() >= 4
    monkeypatch.setattr(opt_parse, "INF", low)
    monkeypatch.setattr(opt_parse_ext, "INF", low)
    if x == "X3":
        got = opt_v1_choice_plain(*_t(args), window=window, literal=literal,
                                  B=B, group=group)
    else:
        got = opt_ext_choice_plain(*_t(args), window=window, literal=literal,
                                   B=B)
    _equal((got[0], got[2]), (want[0], want[2]))
    ok = ~want[2]
    np.testing.assert_array_equal(got[1].numpy()[ok],
                                  np.minimum(want[1][ok], low))


@needs_native
@pytest.mark.parametrize("window,literal", CASES)
def test_host_tables_and_regions_equal_native(window, literal):
    maxpat = compute_min_pattern_size(window, literal) + 131
    rng = np.random.default_rng(window)
    custom = bytes(rng.integers(0, 1 << literal, 1 << window)
                   .astype(np.uint8))
    for k, shard in enumerate(hazard_opt_shards(7, window, literal)):
        arr = np.frombuffer(shard, np.uint8)
        runs, khat, chunks = tencode.opt_ext_runs(arr, window)
        jruns, jkhat, jchunks = jencode.opt_ext_runs(arr, window)
        assert (runs, chunks) == (jruns, jchunks)
        assert (khat is None) == (jkhat is None)
        if khat is not None:
            np.testing.assert_array_equal(khat, jkhat)
        dictionary = custom if k % 2 else None
        got = host_v1_tables(arr, window=window, literal=literal, cap=maxpat,
                             dictionary=dictionary, khat=khat)
        want = _native.native_v1_tables(arr, window, literal, maxpat,
                                        dictionary=dictionary, ext_dict=True,
                                        khat=khat)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the v1 window (the default at literal 8) at the v1 cap
    arr = np.frombuffer(shard, np.uint8)
    cap = min(16, maxpat - 118)
    got = host_v1_tables(arr, window=window, literal=literal, cap=cap,
                         dictionary=dictionary_array(1 << window, 8))
    want = _native.native_v1_tables(arr, window, literal, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@needs_native
def test_choice_walk_equals_native():
    window, literal = 10, 8
    shards = hazard_opt_shards(2, window, literal)
    args = ext_opt_inputs(shards, window, literal)
    choice = opt_ext_choice(*_t(args), window=window,
                            literal=literal)[0].numpy()
    minp = compute_min_pattern_size(window, literal)
    kinds_seen = set()
    for i, shard in enumerate(shards):
        n = len(shard)
        runs = tencode.opt_ext_runs(np.frombuffer(shard, np.uint8),
                                    window)[0]
        sizes, kinds = opt_ext_walk(choice[i, :n], minp, runs)
        want = _native.native_opt_ext_walk(choice[i, :n], minp, runs)
        np.testing.assert_array_equal(sizes, want[0])
        np.testing.assert_array_equal(kinds, want[1])
        assert int(sizes.astype(np.int64).sum()) == n
        kinds_seen |= set(kinds.tolist())
    assert kinds_seen == {0, 1, 2, 3}
    stuck = np.zeros(5, np.uint8)
    with pytest.raises(ValueError):
        opt_ext_walk(stuck, minp)
    with pytest.raises(ValueError):
        _native.native_opt_ext_walk(stuck, minp)


@pytest.mark.parametrize("x", ["X3", "X4"])
def test_shard_size_guard_matches_jax(x, monkeypatch):
    """The JAX DPs refuse a shard of 2^23 positions, whose cost could reach
    their INF.  The port's have no such guard, since their combines rebase
    the boundary vectors (test_plain_rebase_keeps_costs_below_inf, and on
    the card test_optimal_kernels_past_inf_equal_plain): the wrapper hands
    the shard to its DP."""
    from tamp_tpu_torch.ops import opt_parse, opt_parse_ext

    NP = 1 << 23
    window, literal = 10, 8
    zeros = np.zeros((1, NP), np.int32)
    npos = np.asarray([NP], np.int32)
    with pytest.raises(ValueError, match="shard too large"):
        if x == "X3":
            _jax_x3((zeros, zeros.astype(np.uint8), npos), window, literal)
        else:
            _jax_x4((zeros, None, npos, zeros[:, :128] + NP,
                     zeros[:, :128]), window, literal)
    seen = []

    def dp(first, *args, **kw):
        seen.append(tuple(first.shape))
        return "ran"

    monkeypatch.setattr(opt_parse, "opt_v1_choice_plain", dp)
    monkeypatch.setattr(opt_parse_ext, "opt_ext_choice_plain", dp)
    if x == "X3":
        got = opt_v1_choice(*_t((zeros, zeros.astype(np.uint8), npos)),
                            window=window, literal=literal)
    else:
        got = opt_ext_choice(*_t((zeros, None, npos, zeros[:, :128] + NP,
                                  zeros[:, :128])), window=window,
                             literal=literal)
    assert got == "ran" and seen == [(1, NP)]
