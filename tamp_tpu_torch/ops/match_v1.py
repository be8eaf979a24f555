"""v1 match tables (kernel B5), the probe family, and their plain versions.

Counterpart of ``tamp_tpu/ops/match_pallas.py::_search_pallas`` (the
``_kernel_body`` kernel) as the fused v1 encode calls it.  For S shards of
raw bytes ``data`` (S, NP) uint8 with valid lengths ``npos`` and a (W,)
uint8 window dictionary, per position t:

- ``flen, fidx``: the longest linear-buffer match of ``data[s, t:]`` (runs
  stop at npos, at most 16 bytes) against the window model
  ``C = dict || data[s]``, scored at ``cap`` (15 or 16:
  ``min(16, minp + 13)``), lowest ring slot among the longest;
- ``plen, pidx`` (``probe=True``): the lazy probe, target ``data[s, t+1:]``
  against the ring at t (the literal at t not yet written), cap 15.

Positions >= npos hold len 0, index 0.  The semantics oracle is
``engine/search_np.match_tables`` of the JAX package; the CUDA kernel is
``csrc/match_ext.cu`` (entry ``tpt_v1_tables``).  :func:`families_plain`
also serves the probe family of kernel B2 (ops/match_ext.py).
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["v1_tables", "v1_tables_plain", "families_plain", "LMAX",
           "PROBE_CAP"]

LMAX = 16       # longest run the v1 search observes (the 16-byte look-ahead)
PROBE_CAP = 15  # the probe target drops the first look-ahead byte


def runs_down(eq: torch.Tensor, cap: int) -> torch.Tensor:
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


def _best(u: torch.Tensor, cap_lin: torch.Tensor, window_bits: int):
    """(len, slot) of the packed-score maximum over dim 2."""
    W = 1 << window_bits
    sc = ((u << window_bits) + cap_lin - 1).amax(2)
    return sc >> window_bits, (W - 1) - (sc & (W - 1))


def families_plain(row: torch.Tensor, npos: torch.Tensor,
                   dict_arr: torch.Tensor, *, window_bits: int, cap,
                   probe: bool):
    """The main family at ``cap`` (None: skip it) and, with ``probe``, the
    probe family, in plain tensor ops on the inputs' device.  Returns a
    list of (S, MP) int32 planes: ``[len, idx][, plen, pidx]``.

    Per chunk of T positions it builds the (S, T + 17, W) equality matrix
    ``d[t] == C[t + j]``, run lengths down its columns (capped at 16), and
    the head-crossing continuations ``d[t + dd + k] == C[t + k]`` for
    dd = 1..16, then patches the glue diagonals as the oracle does: the
    main family at column W - delta continues with continuation ``delta``,
    the probe (the main run of t + 1 one column left) with ``delta + 1``,
    and the probe's column 0 is continuation 1."""
    S, MP = row.shape
    W = 1 << window_bits
    dev = row.device
    T = max(64, min(4096, (1 << 22) // W, MP))  # positions per chunk
    R = T + LMAX + 1
    n = npos.to(device=dev, dtype=torch.int64).view(S, 1)
    clen = W + MP + R
    C = torch.full((S, clen), -1, dtype=torch.int32, device=dev)
    C[:, :W] = dict_arr.to(device=dev, dtype=torch.int32)
    C[:, W : W + MP] = row.to(torch.int32)
    C = torch.where(torch.arange(clen, device=dev) < W + n, C, -1)
    dlen = MP + R + LMAX + 1
    d = torch.full((S, dlen), 0x1FF, dtype=torch.int32, device=dev)
    d[:, :MP] = row.to(torch.int32)
    d = torch.where(torch.arange(dlen, device=dev) < n, d, 0x1FF)

    Cw = C.unfold(1, W, 1)           # Cw[s, p, j] = C[s, p + j]
    dg = d.unfold(1, LMAX + 1, 1)    # dg[s, p, k] = d[s, p + k]
    delta = torch.arange(1, LMAX, device=dev, dtype=torch.int16)  # 1..15
    cols = W - delta.long()          # ring column of glue distance delta
    jcol = torch.arange(W, device=dev, dtype=torch.int32)
    n_out = (2 if cap is not None else 0) + (2 if probe else 0)
    outs = [torch.empty((S, MP), dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    for t0 in range(0, MP, T):
        Tc = min(T, MP - t0)
        eq = Cw[:, t0 : t0 + R] == d[:, t0 : t0 + R, None]
        L = runs_down(eq, LMAX)                     # (S, R, W)
        geq = dg[:, t0 : t0 + R, 1:] == C[:, t0 : t0 + R, None]
        G = runs_down(geq, LMAX)[:, :Tc]            # G[..., dd - 1]: dd
        tau = (t0 + torch.arange(Tc, device=dev, dtype=torch.int32)) & (W - 1)
        x = (tau[:, None] + jcol[None, :]) & (W - 1)
        cap_lin = W - x
        glue_ok = tau[None, :, None] >= delta
        k = 0
        if cap is not None:
            Lm = L[:, :Tc].clone()
            Lc = Lm[:, :, cols]
            glue = glue_ok & (Lc >= delta)
            Lm[:, :, cols] = torch.where(
                glue, delta + torch.clamp_max(G[:, :, :LMAX - 1],
                                              LMAX - delta), Lc)
            u = torch.clamp_max(torch.minimum(Lm, cap_lin), cap)
            outs[0][:, t0 : t0 + Tc], outs[1][:, t0 : t0 + Tc] = _best(
                u, cap_lin, window_bits)
            k = 2
        if probe:
            pu = torch.zeros_like(L[:, :Tc])
            pu[:, :, 1:] = L[:, 1 : Tc + 1, : W - 1]
            Pc = pu[:, :, cols]
            glue = glue_ok & (Pc >= delta)
            pu[:, :, cols] = torch.where(
                glue, delta + torch.clamp_max(G[:, :, 1:], LMAX - delta), Pc)
            pu[:, :, 0] = G[:, :, 0]
            u = torch.clamp_max(torch.minimum(pu, cap_lin), PROBE_CAP)
            outs[k][:, t0 : t0 + Tc], outs[k + 1][:, t0 : t0 + Tc] = _best(
                u, cap_lin, window_bits)
    return outs


def v1_tables_plain(data: torch.Tensor, npos: torch.Tensor,
                    dict_arr: torch.Tensor, *, window_bits: int, cap: int,
                    probe: bool = False):
    """B5 in plain tensor ops, on the inputs' device."""
    return tuple(families_plain(data, npos, dict_arr,
                                window_bits=window_bits, cap=cap,
                                probe=probe))


def check_inputs(row, npos, dict_arr, window_bits):
    if row.dtype != torch.uint8 or row.dim() != 2:
        raise ValueError("the shard rows must be a (S, MP) uint8 tensor")
    if npos.dtype != torch.int32 or npos.shape != (row.shape[0],):
        raise ValueError("npos must be an (S,) int32 tensor")
    if dict_arr.dtype != torch.uint8 or dict_arr.shape != (1 << window_bits,):
        raise ValueError("dict_arr must be a (W,) uint8 tensor")
    if not (npos.device == dict_arr.device == row.device):
        raise ValueError("the rows, npos and dict_arr must share one device")
    if row.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {row.device}")


def launch_tables(entry: str, row, npos, dict_arr, n_out: int, n_null: int,
                  *scalars: int):
    """Run the C entry ``entry`` of ``csrc/match_ext.cu`` on CUDA tensors:
    the inputs, ``n_out`` fresh (S, MP) int32 planes and ``n_null`` null
    pointers (planes the entry does not write), then S, MP and
    ``scalars``.  Returns the planes."""
    S, MP = row.shape
    outs = tuple(torch.empty((S, MP), dtype=torch.int32, device=row.device)
                 for _ in range(n_out))
    _build.launch("match_ext", entry, row.device,
                  (row.contiguous(), npos.contiguous(), dict_arr.contiguous(),
                   *outs, *([None] * n_null)), (S, MP, *scalars))
    return outs


def v1_tables(data: torch.Tensor, npos: torch.Tensor, dict_arr: torch.Tensor,
              *, window_bits: int, cap: int, probe: bool = False):
    """(flen, fidx[, plen, pidx]): kernel B5 for CUDA tensors, the plain
    version for CPU tensors."""
    check_inputs(data, npos, dict_arr, window_bits)
    if cap not in (15, 16):
        raise ValueError("cap must be 15 or 16")
    if data.device.type == "cpu":
        return v1_tables_plain(data, npos, dict_arr, window_bits=window_bits,
                               cap=cap, probe=probe)
    n_out = 4 if probe else 2
    outs = launch_tables("tpt_v1_tables", data, npos, dict_arr, n_out,
                         4 - n_out, window_bits, cap, int(probe))
    v1_tables.launches += 1
    return outs


v1_tables.launches = 0
