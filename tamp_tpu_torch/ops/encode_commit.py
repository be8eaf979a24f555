"""Planned-fields commit (kernel B3) and its plain version.

Counterpart of ``tamp_tpu/ops/encode_commit_pallas.py::_commit_fields_batch``
(the ``_kernel_fields`` kernel, dual mode).  Per shard, a serial walk over
the planned fields (ops/plan_ext.py): push each visited position's field
into a bit accumulator, drain 32-bit words MSB-first (bytes big-endian),
jump by the position's advance, stop at the first position >= npos - 15.
Returns the byte rows (S, max_out) uint8 (zero past S_NBYTES) and the
state rows (S, 16) int32 in the JAX package's slot layout.  The CUDA
kernel is ``csrc/encode_commit.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["commit_fields", "commit_fields_plain", "S_T", "S_NBYTES",
           "S_ACC", "S_AN", "S_ERR", "S_NSLOTS", "ERR_EXCESS", "ERR_STALL",
           "TILE"]

TILE = 512  # the smallest padded model length the pipeline uses
ERR_EXCESS = 1
ERR_STALL = 2  # a zero advance: malformed fields (the planner never makes one)
# state-row slots (per-shard output), as in the JAX package
S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR, S_NSLOTS = \
    0, 1, 2, 3, 4, 5, 6, 16


def _walk(a, b, npos: int, out: np.ndarray, idx_bits: int):
    """One shard's walk on Python ints; returns the state row values."""
    hard_stop = npos - 15
    t = err = an = nbytes = 0
    acc = 0
    mask64 = (1 << 64) - 1
    while t < hard_stop:
        m = b[t]
        fields = [(a[t] & 0xFFFFFFFF, m & 63)]
        if idx_bits and (m >> 15) & 1:  # split extended index, pushed second
            fields.append(((m >> 16) & 0x7FFF, idx_bits))
        for v, nb in fields:
            acc = ((acc << nb) | v) & mask64
            an += nb
            if an >= 32:
                w = (acc >> (an - 32)) & 0xFFFFFFFF
                if nbytes + 4 <= out.shape[0]:
                    out[nbytes : nbytes + 4] = (
                        w >> 24, (w >> 16) & 255, (w >> 8) & 255, w & 255)
                nbytes += 4
                an -= 32
        adv = (m >> 6) & 255
        if m & (1 << 14) or adv == 0:
            err = ERR_EXCESS if m & (1 << 14) else ERR_STALL
            t = npos
            break
        t += adv
    return t, nbytes, acc & ((1 << an) - 1), an, err


def commit_fields_plain(A: torch.Tensor, B: torch.Tensor, npos: torch.Tensor,
                        *, max_out: int, idx_bits: int = 0):
    """B3 as a Python loop per shard (on host copies of the inputs);
    results are returned on the inputs' device."""
    S = A.shape[0]
    a_h = A.cpu().numpy()
    b_h = B.cpu().numpy()
    n_h = npos.cpu().numpy()
    out = np.zeros((S, max_out), np.uint8)
    state = np.zeros((S, S_NSLOTS), np.int32)
    for s in range(S):
        n = int(n_h[s])
        lim = max(n - 15, 0)
        # the walk reads < hard_stop + 1 positions; a jump never needs more
        a = a_h[s, :lim].tolist()
        b = b_h[s, :lim].tolist()
        t, nbytes, acc, an, err = _walk(a, b, n, out[s], idx_bits)
        state[s, [S_T, S_NBYTES, S_ACC, S_AN, S_CIDX, S_CSZ, S_ERR]] = (
            t, nbytes, acc, an, -1, 0, err)
    dev = A.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(state).to(dev)


def commit_fields(A: torch.Tensor, B: torch.Tensor, npos: torch.Tensor, *,
                  max_out: int, idx_bits: int = 0):
    """(bytes (S, max_out) uint8, state (S, 16) int32): kernel B3 for CUDA
    tensors, the plain version for CPU tensors."""
    if A.dtype != torch.int32 or B.dtype != torch.int32 or A.dim() != 2 \
            or A.shape != B.shape:
        raise ValueError("A and B must be (S, NP) int32 tensors")
    if npos.dtype != torch.int32 or npos.shape != (A.shape[0],):
        raise ValueError("npos must be an (S,) int32 tensor")
    if not (A.device == B.device == npos.device):
        raise ValueError("A, B and npos must share one device")
    if A.device.type == "cpu":
        return commit_fields_plain(A, B, npos, max_out=max_out,
                                   idx_bits=idx_bits)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    lib = _build.load("encode_commit")
    fn = lib.tpt_commit_fields
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    S, NP = A.shape
    A = A.contiguous()
    B = B.contiguous()
    npos = npos.contiguous()
    out = torch.zeros((S, max_out), dtype=torch.uint8, device=A.device)
    state = torch.empty((S, S_NSLOTS), dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), B.data_ptr(), npos.data_ptr(), out.data_ptr(),
                state.data_ptr(), S, NP, max_out, idx_bits, stream)
    _build.check(rc, "commit_fields kernel")
    commit_fields.launches += 1
    return out, state


commit_fields.launches = 0
