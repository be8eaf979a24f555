"""The host half of the planned extended encode in the port's C++
(engine/greedy.host_ext_prep and host_ext_tail_bits, ``tpt_ext_prep`` and
``tpt_ext_tail_bits`` of csrc/greedy_commit.cpp) against the JAX package's
native entries (``_native.native_ext_prep``, ``native_ext_tail_bits``) and
the port's plain versions (engine/plan.ext_prep, engine/tail.ext_tail_bits),
exactly; and the main path (engine/pipeline_ext.encode_ext_device_commit,
``engine="device"``) through them alone."""

import numpy as np
import pytest
import torch

from tamp_tpu import _native
from tamp_tpu import ExcessBitsError as JaxExcessBitsError
from tamp_tpu.engine.encode_extended import encode_extended as jax_extended
from tamp_tpu.engine.pipeline_ext import encode_ext_device_commit as jax_enc
from tamp_tpu_torch import ExcessBitsError
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.engine import greedy, plan, tail
from tamp_tpu_torch.engine.encode_extended import encode_extended_batch
from tamp_tpu_torch.engine.greedy import host_ext_prep, host_ext_tail_bits
from tamp_tpu_torch.engine.pipeline_ext import (
    encode_ext_device_commit, ext_fields, prepare_batch, resume_position,
)
from tamp_tpu_torch.engine.plan import ext_prep
from tamp_tpu_torch.engine.tail import TAIL_ROWS, ext_tail_bits
from tamp_tpu_torch.ops.encode_commit import S_ACC, S_AN, S_T, commit_fields
from test_torch_tail import _text as _tail_text
from test_torch_tail import _walk_starts

pytestmark = pytest.mark.skipif(not _native.available(),
                                reason="native engine unavailable")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain kernels run many small tensor ops: one intra-op thread
    runs them as fast as eight here and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(n: int, seed: int, mask: int = 255) -> bytes:
    """tests/test_torch_tail.py's seeded text, masked to ``mask``."""
    return bytes(b & mask for b in _tail_text(n, seed))


def _run_heavy(n: int, seed: int) -> bytes:
    """Text with runs of 1-600 equal bytes between its words."""
    rng = np.random.default_rng(seed)
    text = _text(n, seed)
    out, t = bytearray(), 0
    while len(out) < n:
        k = int(rng.integers(5, 60))
        out += text[t : t + k] + bytes([int(rng.integers(97, 100))]) * int(
            rng.integers(1, 600))
        t = (t + k) % max(1, len(text) - 60)
    return bytes(out[:n])


# the chunk rule's edges: a run of L equal bytes after a 3-byte lead, so
# the run's first byte is ordinary and its region holds L - 1 bytes
_RUNS = [8, 9, 10, 241, 242, 243, 482, 483]
PREP_INPUTS = {
    "empty": b"",
    "one byte": b"a",
    **{f"run {L}": b"xyz" + b"r" * L + b"tail" for L in _RUNS},
    "5000 equal": b"q" * 5000,
    "5000 equal after text": _text(120, 0) + b"q" * 5000,
    "run-heavy text": _run_heavy(6000, 1),
    "random bytes": np.random.default_rng(2).integers(
        0, 256, 4000).astype(np.uint8).tobytes(),
}


@pytest.mark.parametrize("name", list(PREP_INPUTS))
@pytest.mark.parametrize("window", range(8, 16))
def test_host_ext_prep_equals_native_and_plain(window, name):
    arr = np.frombuffer(PREP_INPUTS[name], np.uint8)
    got = host_ext_prep(arr, window)
    for want in (_native.native_ext_prep(arr, window), ext_prep(arr, window)):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
    plans, khat, dh, rc = got
    assert plans.shape[1] == 2 and khat.shape == (arr.shape[0] + 1,)
    assert dh.shape == rc.shape == (int(khat[-1]),)


def test_host_ext_prep_keeps_stop_at_the_ring_end():
    # 5000 equal bytes after 120 of text at w8: the ring end cuts one
    # chunk's keep below 8, the chunk ending exactly at the ring end
    arr = np.frombuffer(PREP_INPUTS["5000 equal after text"], np.uint8)
    plans, khat, dh, rc = host_ext_prep(arr, 8)
    assert plans.tolist() == [[121, 5120]]
    starts = np.flatnonzero(rc)
    keeps = np.diff(np.append(starts, dh.shape[0]))
    assert rc[starts].tolist() == [241] * 20 + [179]
    assert keeps.tolist().count(8) == 20 and (keeps < 8).sum() == 1
    assert (starts + keeps)[keeps < 8] % 256 == 0


@pytest.mark.parametrize("name", ["run 483", "run-heavy text"])
def test_resume_position_maps_model_to_input(name):
    # the kept input position holding each model position, and the input's
    # end past the model's
    arr = np.frombuffer(PREP_INPUTS[name], np.uint8)
    _plans, khat, dh, _rc = host_ext_prep(arr, 10)
    M = dh.shape[0]
    kept = np.flatnonzero(np.diff(khat.astype(np.int64)))
    got = [resume_position(khat, t_m, M) for t_m in range(M + 2)]
    assert got == kept.tolist() + [arr.shape[0]] * 2


def _stage(arrs, d, window, literal, lazy):
    """The port's host prep, the four match tables, the walk's B field
    plane and the commit state of a batch (plain versions on the CPU)."""
    prep, dh, rc, npos = prepare_batch(arrs, window=window)
    tabs, A, B = ext_fields(
        torch.from_numpy(dh), torch.from_numpy(rc), torch.from_numpy(npos),
        torch.from_numpy(d.copy()), window=window, literal=literal,
        lazy=lazy)
    NP = dh.shape[1]
    _, state = commit_fields(A, B, torch.from_numpy(npos),
                             max_out=NP + NP // 8 + 64,
                             idx_bits=window if window >= 14 else 0)
    return prep, [t.numpy() for t in tabs], B.numpy(), state.numpy()


def _shards(window, literal, kind, dictionary):
    mask = (1 << literal) - 1
    if kind == "ring ends":  # chunks and matches meet the ring end often
        base = _text(600, 3, mask)
        return [base[: 300 + k] + bytes([109 & mask]) * (40 + 9 * k)
                + base[:20] for k in range(0, 200, 23)]
    if dictionary is not None:
        return [_text(700, 4, mask) + bytes([121 & mask]) * 90,
                dictionary[:40]]
    # the plain tables cost O(W) a position: shorter text at w14
    runs, size = ((0, 5, 12, 700, 300), 900) if window <= 10 else ((12, 700),
                                                                   450)
    shards = [_text(size + 37 * k, window + k) + bytes([98 + k]) * run
              for k, run in enumerate(runs)]
    shards += [b"", b"a", b"abcdefg", b"q" * 15, b"qq" * 8, b"z" * 17]
    return [bytes(b & mask for b in s) for s in shards]


TAIL_CASES = [(w, 8, "text") for w in (8, 10, 14)] + [
    (10, lit, "text") for lit in (5, 6, 7)] + [
    (8, 8, "ring ends"), (10, 8, "custom dictionary"),
    (10, 6, "custom dictionary")]


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("window,literal,kind", TAIL_CASES)
def test_host_ext_tail_bits_equals_native_and_plain(window, literal, kind,
                                                     lazy):
    dictionary = None
    if kind == "custom dictionary":
        rng = np.random.default_rng(9)
        dictionary = bytes(rng.integers(97, 106, 1 << window).astype(
            np.uint8) & ((1 << literal) - 1))
    d = (np.frombuffer(dictionary, np.uint8) if dictionary is not None
         else dictionary_array(1 << window, literal=literal))
    arrs = [np.frombuffer(s, np.uint8)
            for s in _shards(window, literal, kind, dictionary)]
    prep, tabs, B, state = _stage(arrs, d, window, literal, lazy)
    for i, arr in enumerate(arrs):
        plans, khat, dhi, _ = prep[i]
        M = dhi.shape[0]

        def three(t_m, acc, an, base, n_rows):
            t_in = (int(np.searchsorted(khat, t_m + 1)) - 1 if t_m < M
                    else arr.shape[0])
            got = host_ext_tail_bits(
                arr, t_in, dhi, khat, plans, window=window, literal=literal,
                acc=acc, an=an, lazy=lazy, dictionary=dictionary)
            want = _native.native_ext_tail_bits(
                arr, t_in, dhi, khat, plans, window=window, literal=literal,
                acc=acc, an=an, lazy=lazy, dictionary=d.tobytes())
            assert got == want, (i, t_m, t_in)
            # the plain walk has no lazy rule: the planned walk defers only
            # with 16 model bytes ahead, never in the last 15 (the tail)
            if not lazy or t_m >= M - 15:
                assert got == ext_tail_bits(
                    arr, t_in, dhi, khat, plans,
                    tuple(t[i, base : base + n_rows] for t in tabs), base,
                    window=window, literal=literal, acc=acc, an=an,
                    dict_last=int(d[-1])), (i, t_m, t_in)

        # at the commit walk's stop with its bit remainder
        st = state[i]
        three(int(st[S_T]), int(st[S_ACC]), int(st[S_AN]),
              max(M - TAIL_ROWS, 0), TAIL_ROWS)
        # every walk entry in the last 60 model positions: resumes inside
        # forced-RLE regions and at ring ends
        for t_m in _walk_starts(B[i], M):
            if t_m >= M - 60:
                three(t_m, 0, 0, 0, M)


def test_host_ext_tail_bits_errors():
    arr = np.frombuffer(b"x" * 40 + b"\xff", np.uint8)
    plans, khat, dh, _rc = host_ext_prep(arr, 10)
    with pytest.raises(ExcessBitsError):
        host_ext_tail_bits(arr, 30, dh, khat, plans, window=10, literal=7,
                           acc=0, an=0)
    with pytest.raises(JaxExcessBitsError):
        _native.native_ext_tail_bits(arr, 30, dh, khat, plans, window=10,
                                     literal=7, acc=0, an=0)
    for bad in ({"t_in": 42}, {"dh": dh[:-1]}, {"khat": khat[:-1]},
                {"plans": [[5, 3]]}, {"plans": [[1, 42]]},
                {"plans": [1, 2, 3]}):
        kw = {"t_in": 30, "dh": dh, "khat": khat, "plans": plans, **bad}
        with pytest.raises(ValueError):
            host_ext_tail_bits(arr, kw["t_in"], kw["dh"], kw["khat"],
                               kw["plans"], window=10, literal=8, acc=0,
                               an=0)
    for window in (7, 16):
        with pytest.raises(ValueError):
            host_ext_prep(arr, window)


@pytest.fixture
def no_plain(monkeypatch):
    """The plain prep and tail raise: the main path must not reach them."""
    def refuse(*_a, **_k):
        raise AssertionError("the main path reached a plain version")

    for name in ("ext_prep", "plan_runs", "build_model_history",
                 "chunk_counts"):
        monkeypatch.setattr(plan, name, refuse)
    monkeypatch.setattr(tail, "ext_tail_bits", refuse)


def _main_path_shards():
    text = _text(1500, 5)
    return [text[:1300], _run_heavy(1100, 6), text[:700] + b"k" * 500, b"",
            b"x", text[:15], text[:16]]


@pytest.mark.parametrize("lazy", [False, True])
def test_device_commit_encode_reaches_only_the_host_cpp(no_plain, lazy):
    shards = _main_path_shards()
    got = encode_ext_device_commit(shards, window=10, literal=8,
                                   lazy_matching=lazy, device="cpu")
    assert got == jax_enc(shards, window=10, literal=8, lazy_matching=lazy,
                          interpret=True)
    for s, b in zip(shards, got):
        assert bytes(_native.native_decompress(b)) == s


@pytest.mark.parametrize("lazy", [False, True])
def test_device_engine_reaches_only_the_host_cpp(no_plain, lazy):
    shards = _main_path_shards()
    got = encode_extended_batch([np.frombuffer(s, np.uint8) for s in shards],
                                window=10, literal=8, lazy_matching=lazy,
                                device="cpu")
    assert got == [jax_extended(s, window=10, literal=8, lazy_matching=lazy)
                   for s in shards]


def test_sixteen_shards_in_threads_equal_one_at_a_time():
    shards = [_run_heavy(600 + 97 * k, 10 + k) for k in range(16)]
    arrs = [np.frombuffer(s, np.uint8) for s in shards]
    threaded = prepare_batch(arrs, window=8)[0]
    for a, x in zip(threaded, arrs):
        assert all(np.array_equal(u, v)
                   for u, v in zip(a, host_ext_prep(x, 8)))
    batch = encode_ext_device_commit(shards, window=8, device="cpu")
    assert batch == [encode_ext_device_commit([s], window=8, device="cpu")[0]
                     for s in shards]


def test_a_failed_host_library_raises_without_falling_back(no_plain,
                                                           monkeypatch):
    def unbuilt(name):
        raise RuntimeError(f"build failed: {name}")

    monkeypatch.setattr(greedy, "_host_entry", unbuilt)
    with pytest.raises(RuntimeError, match="build failed: tpt_ext_prep"):
        encode_ext_device_commit([b"abc" * 20], device="cpu")
    with pytest.raises(RuntimeError, match="build failed: tpt_ext_prep"):
        encode_extended_batch([np.frombuffer(b"abc" * 20, np.uint8)],
                              device="cpu")


def test_the_tail_validates_its_configuration():
    arr = np.frombuffer(b"abc", np.uint8)
    plans, khat, dh, _rc = host_ext_prep(arr, 10)
    for window, literal in ((10, 4), (10, 9), (7, 8), (16, 8)):
        with pytest.raises(ValueError):
            host_ext_tail_bits(arr, 0, dh, khat, plans, window=window,
                               literal=literal, acc=0, an=0)


def test_host_prep_probe_runs_at_a_tiny_size(capsys):
    from tools import torch_host_prep_probe

    assert torch_host_prep_probe.main([
        "--device", "cpu", "--mb", "0.03125", "--shard-kib", "8",
        "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for part in ("pool, a no-op", "prep, C entry alone", "prep, NumPy",
                 "tails, C entry alone", "tails, ext_tails",
                 "tails, a thread a shard", "memory, np.ones"):
        assert part in out
