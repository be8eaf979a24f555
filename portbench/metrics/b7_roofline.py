"""``b7_roofline``: kernel B7 (csrc/greedy_predict.cu, its three launches)
against its roofline, by ``chip_smoke.py`` phase 4's count: one walker-plane
word read a step (4 a token of the traced streams), the start bitmap
written whole (S x L / 8), one entry word a match (4 a match) and the
state rows (36 S)."""

from portbench.harness.roofline import shape_bytes, share, stream_work

KERNEL = r"predict_(maps|entries|pack)_kernel"


def read(run):
    s, w = shape_bytes(run), stream_work(run)
    if w is None:
        return None
    return share(run, KERNEL, 4 * w["tokens"] + s["S"] * s["L"] / 8
                 + 4 * w["matches"] + 36 * s["S"])
