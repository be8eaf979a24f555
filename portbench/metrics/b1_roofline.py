"""``b1_roofline``: kernel B1 (``tables_kernel<false, true>`` of
csrc/match_ext.cu, the planned encode's four tables of the model stream)
against its roofline, by ``chip_smoke.py`` phase 4's count: the padded
model bytes read (S x NP), four int32 planes written (16 S x NP), the
dictionary (W) and the lengths (4 S).  NP is a call's longest model stream
padded to a power of two (at least 512), the model streams the plain
planned encoder's (:func:`portbench.reference.tamp_planned.model`) of the
traced calls' inputs."""

from portbench.harness.roofline import shape_bytes, share
from portbench.reference import tamp_planned

KERNEL = r"tables_kernel<false, true>"
TILE = 512


def _np(data: bytes, shard: int, window: int) -> int:
    m = max([len(tamp_planned.model(data[i : i + shard], window)[2])
             for i in range(0, len(data), shard)] or [0])
    return 1 << (max(m, TILE) - 1).bit_length()


def read(run):
    if run.trace is None:
        return None
    s = shape_bytes(run)
    pool = len(run.inputs)
    nps = run.state.setdefault("b1_np", {})
    for k in range(run.trace.calls):
        j = (run.trace.first + k) % pool
        if j not in nps:
            nps[j] = _np(run.inputs[j], run.shard_bytes,
                         int(run.config["window"]))
    NP = sum(nps[(run.trace.first + k) % pool]
             for k in range(run.trace.calls)) / run.trace.calls
    return share(run, KERNEL, 17 * s["S"] * NP + s["W"] + 4 * s["S"])
