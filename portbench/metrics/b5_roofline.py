"""``b5_roofline``: kernel B5 (``tables_kernel<false, false>`` of
csrc/match_ext.cu, the v1 tables without the probe) against its roofline:
the shards read once (S x L), the dictionary (W) and the lengths (4 S),
two int32 planes written (8 S x L)."""

from portbench.harness.roofline import shape_bytes, share

KERNEL = r"tables_kernel<false, false>"


def read(run):
    s = shape_bytes(run)
    return share(run, KERNEL, 9 * s["S"] * s["L"] + s["W"] + 4 * s["S"])
