"""What the decode entry points share: the pool's containers, made in set-up by
the port's own encoder at the configuration's settings, the accounting,
the check and the control."""

from __future__ import annotations

from portbench.harness.program import encode_kwargs
from portbench.reference.check import check_decode, control_decode

__all__ = ["setup", "account", "check", "control", "containers"]


def setup(run, decode) -> None:
    """Make the containers; ``decode(blob)`` is the timed call."""
    from tamp_tpu_torch.parallel.shard import compress_sharded

    kw = encode_kwargs(run)
    blobs = [compress_sharded(x, **kw) for x in run.inputs]
    run.state["containers"] = blobs
    run.state["call"] = lambda i: decode(blobs[i % len(blobs)])


def account(run, i: int, result) -> tuple[int, int]:
    """(raw bytes out, container bytes in) of call ``i``."""
    blobs = run.state["containers"]
    return len(result), len(blobs[i % len(blobs)])


def containers(run) -> list:
    """The container of each pool input."""
    return run.state["containers"]


def check(run, kept: dict) -> dict:
    inputs = run.inputs
    return check_decode(
        [(inputs[i % len(inputs)], out) for i, out in sorted(kept.items())],
        list(zip(inputs, run.state["containers"])),
        shard_bytes=run.shard_bytes,
        sample=int(run.traffic["check_shards"]), seed=run.seed)


def control(run):
    blobs = run.state["containers"]
    return lambda i: control_decode(blobs[i % len(blobs)])
