"""``b4_roofline``: kernel B4 (``commit_decode_kernel`` of
csrc/decode_commit.cu) against its roofline, by ``chip_smoke.py`` phase 4's
count: one parse word read a token (4 a token of the traced streams), the
two dictionaries (2 W), the raw output written once and 8 bytes a shard."""

from portbench.harness.roofline import shape_bytes, share, stream_work

KERNEL = r"commit_decode_kernel"


def read(run):
    s, w = shape_bytes(run), stream_work(run)
    if w is None:
        return None
    return share(run, KERNEL, 4 * w["tokens"] + 2 * s["W"] + s["raw"]
                 + 8 * s["S"])
