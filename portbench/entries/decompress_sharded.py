"""Entry point ``tamp_tpu_torch.parallel.shard.decompress_sharded`` (kernel
X2, ``2 * workers`` shards a launch): a call decodes one pool container,
with the traffic's ``workers`` passed explicitly so that the host's CPU
count changes nothing."""

from __future__ import annotations

from portbench.harness import decoding


def setup(run) -> None:
    from tamp_tpu_torch.parallel.shard import decompress_sharded

    workers, dev = int(run.traffic["workers"]), run.prog_device
    decoding.setup(run, lambda blob: decompress_sharded(
        blob, workers=workers, device=dev))


def call(run, i: int):
    return run.state["call"](i)


account, check, control, containers = (
    decoding.account, decoding.check, decoding.control, decoding.containers)
