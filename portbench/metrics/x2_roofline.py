"""``x2_roofline``: kernel X2 (``serial_decode_kernel`` of
csrc/decode_serial.cu) against its roofline: the payloads read once (the
container's bytes), the two dictionaries (2 W), the raw output written
once and 12 bytes a shard of lengths and state."""

from portbench.harness.roofline import shape_bytes, share

KERNEL = r"serial_decode_kernel"


def read(run):
    s = shape_bytes(run)
    return share(run, KERNEL, s["packed"] + 2 * s["W"] + s["raw"]
                 + 12 * s["S"])
