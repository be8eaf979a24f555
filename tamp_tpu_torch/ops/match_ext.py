"""Extended match tables (kernels B1 and B2) and their plain PyTorch versions.

Counterpart of ``tamp_tpu/ops/match_ext_pallas.py::ext_tables_pallas``:
B1 is its ``_kernel_swar`` kernel, B2 its byte kernel ``_kernel`` with the
probe family (``probe=True``, the lazy extended encode).  For S shards of
model-history bytes ``dh`` (S, MP) uint8 with valid lengths ``npos`` and a
(W,) uint8 window dictionary, B1 returns ``(len16, idx16, lenx, idxx)``,
each (S, MP) int32: the longest linear-buffer match of ``dh[s, t:]`` (runs
stop at npos) against the window model ``C = dict || dh[s]`` at caps 16
and ``LEXT``, lowest ring slot among the longest.  B2 adds ``(plen,
pidx)``: target ``dh[s, t+1:]`` against the ring at t, cap 15 (see
ops/match_v1.py).  Positions >= npos hold len 0, index 0.  The semantics
oracles are ``engine/search_np.match_tables_ext`` and ``match_tables`` of
the JAX package.  On the card B1 and B2 are instantiations of the one
filtered table kernel of ``csrc/match_ext.cu`` that also serves B5: B5's
bit-plane filter and main family, and a long family that goes on past 16
bytes only where a survivor's 16 bytes all match.
"""

from __future__ import annotations

import torch

from .match_v1 import check_inputs, families_plain, launch_tables, runs_down

__all__ = ["ext_tables", "ext_tables_plain", "ext_tables_probe",
           "ext_tables_probe_plain"]


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
        L = runs_down(eq, LEXT)[:, :Tc]
        geq = dg[:, t0 : t0 + R, 1:] == C[:, t0 : t0 + R, None]
        G = runs_down(geq, LEXT)[:, :Tc]
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


def ext_tables(dh: torch.Tensor, npos: torch.Tensor, dict_arr: torch.Tensor,
               *, window_bits: int, LEXT: int):
    """(len16, idx16, lenx, idxx): kernel B1 for CUDA tensors, the plain
    version for CPU tensors."""
    check_inputs(dh, npos, dict_arr, window_bits)
    if dh.device.type == "cpu":
        return ext_tables_plain(dh, npos, dict_arr, window_bits=window_bits,
                                LEXT=LEXT)
    outs = launch_tables("tpt_ext_tables", dh, npos, dict_arr, 4, 0,
                         window_bits, LEXT)
    ext_tables.launches += 1
    return outs


ext_tables.launches = 0


def ext_tables_probe_plain(dh: torch.Tensor, npos: torch.Tensor,
                           dict_arr: torch.Tensor, *, window_bits: int,
                           LEXT: int):
    """B2 in plain tensor ops: B1's plain version and the probe family of
    ops/match_v1.py on the model history."""
    return (*ext_tables_plain(dh, npos, dict_arr, window_bits=window_bits,
                              LEXT=LEXT),
            *families_plain(dh, npos, dict_arr, window_bits=window_bits,
                            cap=None, probe=True))


def ext_tables_probe(dh: torch.Tensor, npos: torch.Tensor,
                     dict_arr: torch.Tensor, *, window_bits: int, LEXT: int):
    """(len16, idx16, lenx, idxx, plen, pidx): kernel B2 for CUDA tensors,
    the plain version for CPU tensors."""
    check_inputs(dh, npos, dict_arr, window_bits)
    if dh.device.type == "cpu":
        return ext_tables_probe_plain(dh, npos, dict_arr,
                                      window_bits=window_bits, LEXT=LEXT)
    outs = launch_tables("tpt_ext_tables_probe", dh, npos, dict_arr, 6, 0,
                         window_bits, LEXT)
    ext_tables_probe.launches += 1
    return outs


ext_tables_probe.launches = 0
