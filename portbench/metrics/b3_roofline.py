"""``b3_roofline``: kernel B3 (csrc/encode_commit.cu, its four launches)
against its roofline, by ``chip_smoke.py`` phase 4's count: the planner's
planes A and B read at the walk's positions (8 a token of the traced
streams), the compressed bodies written once and the lengths and state
rows (68 S)."""

from portbench.harness.roofline import shape_bytes, share, stream_work

KERNEL = r"fields_(maps|entries|pack|finish)_kernel"


def read(run):
    s, w = shape_bytes(run), stream_work(run)
    if w is None:
        return None
    return share(run, KERNEL, 8 * w["tokens"] + w["bodies"] + 68 * s["S"])
