"""Extended match tables (kernel B1) and their plain PyTorch version.

Counterpart of ``tamp_tpu/ops/match_ext_pallas.py::ext_tables_pallas``
(the ``_kernel_swar`` kernel).  For S shards of model-history bytes
``dh`` (S, MP) uint8 with valid lengths ``npos`` and a (W,) uint8 window
dictionary, returns ``(len16, idx16, lenx, idxx)``, each (S, MP) int32:
the longest linear-buffer match of ``dh[s, t:]`` (runs stop at npos)
against the window model ``C = dict || dh[s]`` at caps 16 and ``LEXT``,
lowest ring slot among the longest.  Positions >= npos hold len 0,
index 0.  The semantics oracle is ``engine/search_np.match_tables_ext``
of the JAX package; the CUDA kernel is ``csrc/match_ext.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ext_tables", "ext_tables_plain"]


def _runs_down(eq: torch.Tensor, cap: int) -> torch.Tensor:
    """Run lengths of consecutive ones down dim 1 (rows), log-doubled;
    exact wherever ``cap`` rows follow, then capped at ``cap`` (int16: the
    values stay below 2 * cap)."""
    L = eq.to(torch.int16)
    R = L.shape[1]
    k = 1
    while k < cap:
        nxt = torch.zeros_like(L)
        if k < R:
            nxt[:, : R - k] = L[:, k:]
        L = L + torch.where(L == k, nxt, 0)
        k *= 2
    return torch.clamp_max(L, cap)


def ext_tables_plain(dh: torch.Tensor, npos: torch.Tensor,
                     dict_arr: torch.Tensor, *, window_bits: int,
                     LEXT: int):
    """B1 in plain tensor ops, on the inputs' device.

    Per chunk of T positions it builds the (S, T + LEXT, W) equality
    matrix ``d[t] == C[t + j]``, run lengths down its columns, and the
    (S, T + LEXT, LEXT - 1) head-crossing (glue) continuations
    ``d[t + delta + k] == C[t + k]``, then takes the packed-score maximum
    of each family."""
    S, MP = dh.shape
    W = 1 << window_bits
    dev = dh.device
    T = max(64, min(4096, (1 << 22) // W))  # positions per chunk
    R = T + LEXT
    n = npos.to(device=dev, dtype=torch.int64).view(S, 1)
    # C = dict || dh, -1 from W + npos on; targets 0x1FF from npos on
    clen = W + MP + R
    C = torch.full((S, clen), -1, dtype=torch.int32, device=dev)
    C[:, :W] = dict_arr.to(device=dev, dtype=torch.int32)
    C[:, W : W + MP] = dh.to(torch.int32)
    ci = torch.arange(clen, device=dev)
    C = torch.where(ci < W + n, C, -1)
    dlen = MP + R + LEXT
    d = torch.full((S, dlen), 0x1FF, dtype=torch.int32, device=dev)
    d[:, :MP] = dh.to(torch.int32)
    di = torch.arange(dlen, device=dev)
    d = torch.where(di < n, d, 0x1FF)

    Cw = C.unfold(1, W, 1)          # Cw[s, p, j] = C[s, p + j]
    dg = d.unfold(1, LEXT, 1)       # dg[s, p, k] = d[s, p + k]
    dd = torch.arange(1, LEXT, device=dev, dtype=torch.int16)
    cols = W - dd.long()            # ring column of glue distance dd
    jcol = torch.arange(W, device=dev, dtype=torch.int32)
    outs = [torch.empty((S, MP), dtype=torch.int32, device=dev)
            for _ in range(4)]
    for t0 in range(0, MP, T):
        Tc = min(T, MP - t0)
        eq = Cw[:, t0 : t0 + R] == d[:, t0 : t0 + R, None]
        L = _runs_down(eq, LEXT)[:, :Tc]
        geq = dg[:, t0 : t0 + R, 1:] == C[:, t0 : t0 + R, None]
        G = _runs_down(geq, LEXT)[:, :Tc]
        tau = (t0 + torch.arange(Tc, device=dev, dtype=torch.int32)) & (W - 1)
        Lc = L[:, :, cols]
        glue = (tau[None, :, None] >= dd) & (Lc >= dd)
        L[:, :, cols] = torch.where(glue, dd + torch.clamp_max(G, LEXT - dd),
                                    Lc)
        x = (tau[:, None] + jcol[None, :]) & (W - 1)
        cap = W - x
        u = torch.minimum(L, cap)
        for k, fam in ((0, 16), (2, LEXT)):
            sc = ((torch.clamp_max(u, fam) << window_bits) + cap - 1).amax(2)
            outs[k][:, t0 : t0 + Tc] = sc >> window_bits
            outs[k + 1][:, t0 : t0 + Tc] = (W - 1) - (sc & (W - 1))
    return tuple(outs)


def _check_inputs(dh, npos, dict_arr, window_bits):
    if dh.dtype != torch.uint8 or dh.dim() != 2:
        raise ValueError("dh must be a (S, MP) uint8 tensor")
    if npos.dtype != torch.int32 or npos.shape != (dh.shape[0],):
        raise ValueError("npos must be an (S,) int32 tensor")
    if dict_arr.dtype != torch.uint8 or dict_arr.shape != (1 << window_bits,):
        raise ValueError("dict_arr must be a (W,) uint8 tensor")
    if not (npos.device == dict_arr.device == dh.device):
        raise ValueError("dh, npos and dict_arr must share one device")


def ext_tables(dh: torch.Tensor, npos: torch.Tensor, dict_arr: torch.Tensor,
               *, window_bits: int, LEXT: int):
    """(len16, idx16, lenx, idxx): kernel B1 for CUDA tensors, the plain
    version for CPU tensors."""
    _check_inputs(dh, npos, dict_arr, window_bits)
    if dh.device.type == "cpu":
        return ext_tables_plain(dh, npos, dict_arr, window_bits=window_bits,
                                LEXT=LEXT)
    if dh.device.type != "cuda":
        raise ValueError(f"unsupported device {dh.device}")
    lib = _build.load("match_ext")
    fn = lib.tpt_ext_tables
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    S, MP = dh.shape
    dh = dh.contiguous()
    npos = npos.contiguous()
    dict_arr = dict_arr.contiguous()
    outs = [torch.empty((S, MP), dtype=torch.int32, device=dh.device)
            for _ in range(4)]
    stream = torch.cuda.current_stream(dh.device).cuda_stream
    with torch.cuda.device(dh.device):
        rc = fn(dh.data_ptr(), npos.data_ptr(), dict_arr.data_ptr(),
                *(o.data_ptr() for o in outs), S, MP, window_bits, LEXT,
                stream)
    _build.check(rc, "ext_tables kernel")
    ext_tables.launches += 1
    return tuple(outs)


ext_tables.launches = 0
