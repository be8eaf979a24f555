"""Kernels of the port on an NVIDIA card against their plain versions.

Needs a CUDA device; skips without one.  Imports nothing of JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import os

import numpy as np
import pytest
import torch

from tamp_tpu_torch.constants import compute_min_pattern_size
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_commit as dc
from tamp_tpu_torch.ops import decode_serial as dser
from tamp_tpu_torch.ops import decode_wavefront as dw
from tamp_tpu_torch.ops.token_chase import (
    token_table_chase, token_table_chase_plain,
)
from tamp_tpu_torch.ops.encode_commit import (
    commit_fields, commit_fields_plain, commit_v1_lazy, commit_v1_lazy_plain,
)
from tamp_tpu_torch.ops.match_ext import (
    ext_tables, ext_tables_plain, ext_tables_probe, ext_tables_probe_plain,
)
from tamp_tpu_torch.ops.match_v1 import v1_tables, v1_tables_plain
from tamp_tpu_torch.parallel.shard import (
    _parse_frame, compress_sharded, decompress_sharded_device,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 110, rng.integers(2, 8)))
             for _ in range(64)]
    s = b" ".join(words[int(i)] for i in rng.integers(0, 64, n))[:n]
    return s[: n // 2] + b"=" * 300 + s[n // 2 :]


@pytest.mark.parametrize("window", [8, 11, 15])
def test_b1_kernel_equals_plain(cuda, window):
    lext = compute_min_pattern_size(window, 8) + 131
    rng = np.random.default_rng(window)
    dh = torch.from_numpy(rng.integers(97, 101, (2, 4096)).astype(np.uint8))
    npos = torch.tensor([4096, 1500], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    want = ext_tables_plain(dh, npos, d, window_bits=window, LEXT=lext)
    got = ext_tables(dh.to(cuda), npos.to(cuda), d.to(cuda),
                     window_bits=window, LEXT=lext)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("window", [8, 11, 15])
def test_b2_kernel_equals_plain(cuda, window):
    lext = compute_min_pattern_size(window, 8) + 131
    rng = np.random.default_rng(window + 1)
    dh = torch.from_numpy(rng.integers(97, 101, (2, 4096)).astype(np.uint8))
    npos = torch.tensor([4096, 1501], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    want = ext_tables_probe_plain(dh, npos, d, window_bits=window, LEXT=lext)
    got = ext_tables_probe(dh.to(cuda), npos.to(cuda), d.to(cuda),
                           window_bits=window, LEXT=lext)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("cap", [15, 16])
@pytest.mark.parametrize("window", [8, 11, 15])
def test_b5_kernel_equals_plain(cuda, window, cap, probe):
    rng = np.random.default_rng(window * 2 + cap)
    data = torch.from_numpy(rng.integers(97, 100, (2, 4096)).astype(np.uint8))
    data[0, 1000:1300] = 7  # a run: glue zones
    npos = torch.tensor([4096, 1499], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    kw = dict(window_bits=window, cap=cap, probe=probe)
    want = v1_tables_plain(data, npos, d, **kw)
    got = v1_tables(data.to(cuda), npos.to(cuda), d.to(cuda), **kw)
    assert len(got) == len(want) == (4 if probe else 2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_b6_kernel_equals_plain(cuda):
    rng = np.random.default_rng(2)
    S, NP = 3, 4096
    size = rng.integers(0, 17, (S, NP))
    packed = (size << 23) | (rng.integers(0, 1024, (S, NP)) << 8) \
        | rng.integers(0, 128, (S, NP))
    probe = (rng.integers(0, 16, (S, NP)) << 15) | rng.integers(0, 1024,
                                                              (S, NP))
    packed[2, 2480:2520] = 0x41  # literals, then one 0x80+ byte: literal 7
    packed[2, 2500] = 0xC3       # cannot hold it (ERR_EXCESS)
    probe[2, 2480:2520] = 0
    packed = torch.from_numpy(packed.astype(np.int32))
    probe = torch.from_numpy(probe.astype(np.int32))
    npos = torch.tensor([4096, 2000, 4000], dtype=torch.int32)
    kw = dict(window=10, literal=7, max_out=NP + NP // 8 + 64)
    want = commit_v1_lazy_plain(packed, probe, npos, **kw)
    got = commit_v1_lazy(packed.to(cuda), probe.to(cuda), npos.to(cuda), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[1][:, 6].tolist() == [0, 0, 1]


def test_b3_kernel_equals_plain(cuda):
    rng = np.random.default_rng(1)
    S, NP = 3, 4096
    nb = rng.integers(1, 19, (S, NP))
    adv = rng.integers(1, 20, (S, NP))
    A = rng.integers(0, 1 << 18, (S, NP)) & ((1 << nb) - 1)
    B = nb | (adv << 6)
    B[2, 3000:] |= 1 << 14  # an error field ends the third walk
    A = torch.from_numpy(A.astype(np.int32))
    B = torch.from_numpy(B.astype(np.int32))
    npos = torch.tensor([4096, 2000, 4000], dtype=torch.int32)
    kw = dict(max_out=NP + NP // 8 + 64, idx_bits=0)
    want = commit_fields_plain(A, B, npos, **kw)
    got = commit_fields(A.to(cuda), B.to(cuda), npos.to(cuda), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_entry_points_round_trip_and_match_plain(cuda):
    data = _text(40000, 2)
    blob = compress_sharded(data, shard_size=16384)
    assert blob == compress_sharded(data, shard_size=16384, device="cpu")
    before = dc.commit_decode.launches
    assert bytes(decompress_sharded_device(blob)) == data
    assert dc.commit_decode.launches == before + 1
    assert bytes(decompress_sharded_device(blob, device="cpu")) == data
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    for raw, size in ((b"", 1024), (tiny, 7), (tiny, 17)):
        blob = compress_sharded(raw, shard_size=size)
        assert blob == compress_sharded(raw, shard_size=size, device="cpu")
        assert bytes(decompress_sharded_device(blob)) == raw


@pytest.mark.parametrize("kw", [
    {"extended": False}, {"extended": False, "lazy_matching": True},
    {"lazy_matching": True}, {"extended": False, "window": 11, "literal": 5},
])
def test_v1_and_lazy_round_trip_and_match_plain(cuda, kw):
    lmask = (1 << kw.get("literal", 8)) - 1
    data = bytes(b & lmask for b in _text(40000, 4))
    blob = compress_sharded(data, shard_size=16384, **kw)
    assert blob == compress_sharded(data, shard_size=16384, device="cpu",
                                    **kw)
    assert bytes(decompress_sharded_device(blob)) == data
    tiny = b"".join(bytes([97 + k % 3]) * (k % 5) for k in range(40))
    for raw, size in ((b"", 1024), (tiny, 7), (tiny, 17)):
        raw = bytes(b & lmask for b in raw)
        blob = compress_sharded(raw, shard_size=size, **kw)
        assert blob == compress_sharded(raw, shard_size=size, device="cpu",
                                        **kw)
        assert bytes(decompress_sharded_device(blob)) == raw


@pytest.mark.parametrize("window,literal", [(8, 5), (14, 8)])
def test_custom_dictionary_round_trip(cuda, window, literal):
    rng = np.random.default_rng(window)
    dictionary = bytes(rng.integers(0, 1 << literal, 1 << window)
                       .astype(np.uint8))
    data = bytes(b & ((1 << literal) - 1) for b in _text(20000, 3))
    data += dictionary[:3000]
    blob = compress_sharded(data, window=window, literal=literal,
                            dictionary=dictionary, shard_size=8192)
    assert blob == compress_sharded(data, window=window, literal=literal,
                                    dictionary=dictionary, shard_size=8192,
                                    device="cpu")
    assert bytes(decompress_sharded_device(blob, dictionary=dictionary)) \
        == data


def _parse(cuda, streams):
    return dw.payload_parse([b[1:] for b in streams], window=10, literal=8,
                            extended=True, device=cuda)


def test_b8_kernel_equals_plain(cuda):
    blob = compress_sharded(_text(40000, 6), shard_size=16384)
    nxt, _packed = _parse(cuda, _parse_frame(blob)[2])
    NBP = nxt.shape[1]
    T_max = NBP // 9 + 2
    before = token_table_chase.launches
    got = token_table_chase(nxt, NBP, T_max)
    assert token_table_chase.launches == before + 1
    want = token_table_chase_plain(nxt.cpu(), NBP, T_max)
    xla = dw._token_table(nxt, NBP, 8, T_max)
    for g, w, x in zip(got, want, xla):
        assert torch.equal(g.cpu(), w)
        assert torch.equal(x.cpu(), w)


def test_x1_kernel_equals_plain(cuda):
    rng = np.random.default_rng(7)
    S, T_max, W = 40, 3000, 1024
    seg = np.cumsum(rng.random((S, T_max)) < 0.01, axis=1).astype(np.int32)
    s_c = rng.integers(0, 1 << 20, (S, T_max)).astype(np.int32)
    w_c = rng.integers(0, 300, (S, T_max)).astype(np.int32)
    n_tr = rng.integers(0, T_max, S).astype(np.int32)
    args = [torch.from_numpy(x) for x in (seg, s_c, w_c, n_tr)]
    want = dw.trunc_deficits_plain(*args, W)
    before = dw.trunc_deficits.launches
    got = dw.trunc_deficits(*(a.to(cuda) for a in args), W)
    assert dw.trunc_deficits.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) > 0


@pytest.mark.parametrize("window", [8, 10, 15])
def test_x2_kernel_equals_plain(cuda, window):
    data = _text(30000, window)
    data = data[:12000] + b"\x00" * 2000 + data[12000:]
    blob = compress_sharded(data, window=window, shard_size=16384)
    pieces = [p[1:] for p in _parse_frame(blob)[2]]
    bad = bytearray(pieces[0])
    bad[len(bad) // 2] ^= 0x5A
    pieces.append(bytes(bad))
    Lp = max(len(p) for p in pieces)
    pl = np.zeros((len(pieces), Lp), np.uint8)
    for i, p in enumerate(pieces):
        pl[i, : len(p)] = np.frombuffer(p, np.uint8)
    pl = torch.from_numpy(pl)
    nb = torch.tensor([len(p) for p in pieces], dtype=torch.int32)
    d = torch.from_numpy(dictionary_array(1 << window))
    for max_out in (16384, 5000):
        kw = dict(window=window, literal=8, extended=True, more=False,
                  max_out=max_out)
        want = dser.serial_decode_plain(pl, nb, d, d, **kw)
        got = dser.serial_decode(pl.to(cuda), nb.to(cuda), d.to(cuda),
                                 d.to(cuda), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert want[0][0, :5000].numpy().tobytes() == data[:5000]


@pytest.mark.parametrize("mode", ["chase", "xla", "serial"])
def test_decode_modes_round_trip_and_match_plain(cuda, mode):
    data = _text(40000, 5)
    blob = compress_sharded(data, shard_size=16384)
    if mode == "serial":
        kw = dict(algorithm="serial")
        counter = dser.serial_decode
    else:
        kw = {}
        counter = token_table_chase if mode == "chase" else \
            dw.trunc_deficits
    before = (counter.launches, dc.commit_decode.launches)
    prev = os.environ.get("TAMP_TPU_DECODE")
    os.environ["TAMP_TPU_DECODE"] = mode
    try:
        got = decompress_sharded_device(blob, **kw)
        plain = decompress_sharded_device(blob, device="cpu", **kw)
    finally:
        if prev is None:
            del os.environ["TAMP_TPU_DECODE"]
        else:
            os.environ["TAMP_TPU_DECODE"] = prev
    assert bytes(got) == bytes(plain) == data
    assert counter.launches > before[0]
    assert dc.commit_decode.launches == before[1]
