"""Entry point ``tamp_tpu_torch.parallel.shard.decompress_sharded_device``
(the per-bit parse, then the traffic's decode ``mode``; ``commit`` is
kernel B4): a call decodes one pool container, the mode passed explicitly
so that ``TAMP_TPU_DECODE`` changes nothing."""

from __future__ import annotations

from portbench.harness import decoding


def setup(run) -> None:
    from tamp_tpu_torch.parallel.shard import decompress_sharded_device

    mode, dev = run.traffic["mode"], run.prog_device
    decoding.setup(run, lambda blob: decompress_sharded_device(
        blob, mode=mode, device=dev))


def call(run, i: int):
    return run.state["call"](i)


account, check, control, containers = (
    decoding.account, decoding.check, decoding.control, decoding.containers)
