"""Kernels B4's and B3's plain versions against the JAX package's decode
commit and planned-fields commit kernels (interpret mode), on the seeded
hazard streams and fields that the card tests hold the Hopper kernels to
(tests/test_torch_cuda.py makes both).  This pins the plain versions on
exactly the cases the kernels risk.  Exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tamp_tpu.ops.decode_commit_pallas import commit_decode_batch
from tamp_tpu.ops.encode_commit_pallas import _commit_fields_batch
from tamp_tpu_torch.dictionary import dictionary_array
from tamp_tpu_torch.ops import decode_commit as dc
from tamp_tpu_torch.ops import decode_wavefront as dw
from tamp_tpu_torch.ops.encode_commit import (
    S_ACC, S_AN, S_ERR, S_NBYTES, S_T, commit_fields,
)
from test_torch_cuda import hazard_fields, hazard_stream

N_TOKENS = 160  # interpret mode walks a token at a time


@pytest.mark.parametrize("window,kind", [
    (8, "hazards"), (8, "more, double FLUSH"), (10, "out of bounds"),
    (10, "overflow"), (15, "hazards"), (15, "more, double FLUSH")])
def test_b4_plain_matches_pallas_on_hazard_streams(window, kind):
    more = kind.startswith("more")
    streams, lens = zip(*(hazard_stream(
        window * 10 + i, window, more=more, n_tokens=N_TOKENS + 40 * i,
        oob_at=90 + 10 * i if kind == "out of bounds" else -1)
        for i in range(2)))
    max_out = 1 << max(max(lens), 1024).bit_length()
    if kind == "overflow":
        max_out = min(lens) // 2
    skip = 2 if more else 1
    nxt, packed = dw.payload_parse([x[skip:] for x in streams],
                                   window=window, literal=8, extended=True,
                                   device="cpu")
    W = 1 << window
    d = dictionary_array(W, literal=8)
    out, got_lens, errs = dc.commit_decode(
        nxt, packed, torch.from_numpy(d.copy()), torch.from_numpy(d.copy()),
        W=W, more=more, max_out=max_out)
    jo, jl, je = commit_decode_batch(
        jnp.asarray(nxt.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(d.astype(np.int32)), jnp.asarray(d.astype(np.int32)),
        NBP=nxt.shape[1], W=W, more=more, max_out=max_out, unified=False,
        interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(errs.numpy(), np.asarray(je))
    want_err = {"out of bounds": dc.ERR_OOB, "overflow": dc.ERR_OVERFLOW}
    assert errs.tolist() == [want_err.get(kind, dc.ERR_OK)] * 2
    if kind in ("hazards", "more, double FLUSH"):
        assert got_lens.tolist() == list(lens)


@pytest.mark.parametrize("idx_bits,max_out", [
    (0, None), (14, None), (15, None), (0, 64)])
def test_b3_plain_matches_pallas_on_hazard_fields(idx_bits, max_out):
    # rows 0, 1 and 3 of the hazard fields: an error field mid-tile in row
    # 1, values wider than their fields in row 3; the zero-advance row 2 is
    # left out (the TPU kernel spins on it; the card tests hold it)
    NP = 1536
    A, B = (x[[0, 1, 3]] for x in hazard_fields(idx_bits + 5, 4, NP,
                                                 idx_bits))
    npos = np.array([NP, NP - 300, NP - 7], np.int32)
    limit = NP + NP // 8 + 64 if max_out is None else max_out
    out, st = commit_fields(torch.from_numpy(A), torch.from_numpy(B),
                            torch.from_numpy(npos), max_out=limit,
                            idx_bits=idx_bits)
    jout, jst = _commit_fields_batch(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(npos), NP=NP, dual=True,
        max_out=limit, idx_bits=idx_bits, interpret=True)
    jout, jst = np.asarray(jout), np.asarray(jst)
    st = st.numpy()
    for s in range(3):
        for slot in (S_T, S_NBYTES, S_ACC, S_AN, S_ERR):
            assert st[s, slot] == jst[s, slot], (s, slot)
        nb = min(int(st[s, S_NBYTES]), limit & ~3)
        np.testing.assert_array_equal(out[s, :nb].numpy(), jout[s, :nb])
        assert int(out[s, nb:].abs().sum()) == 0
    assert st[:, S_ERR].tolist() == [0, 1, 0]
    if max_out is not None:
        assert (st[:, S_NBYTES] > max_out).any()
