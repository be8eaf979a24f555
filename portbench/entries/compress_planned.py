"""Entry point ``tamp_tpu_torch.parallel.shard.compress_sharded`` with the
configuration's planned engine (``engine="device-commit"``): a call is one
container of a pool input at the configuration's settings and the
traffic's shard size, with the API's own threads.  The streams are judged
by the plain planned encoder (``portbench/reference/check_planned.py``).

The control is the program with the configuration's ``control`` settings
(the greedy path, whose streams are not the planned walk's)."""

from __future__ import annotations

from portbench.harness.program import encode_kwargs
from portbench.reference.check_planned import check_encode_planned


def _caller(run, kw):
    from tamp_tpu_torch.parallel.shard import compress_sharded

    inputs = run.inputs
    return lambda i: compress_sharded(inputs[i % len(inputs)], **kw)


def setup(run) -> None:
    run.state["call"] = _caller(run, encode_kwargs(run))


def call(run, i: int):
    return run.state["call"](i)


def account(run, i: int, result) -> tuple[int, int]:
    """(raw bytes, container bytes) of call ``i``."""
    return len(run.inputs[i % len(run.inputs)]), len(result)


def containers(run) -> list:
    """The container of each pool input (the window's first pass), None
    where that call failed."""
    return [run.kept.get(j) for j in range(len(run.inputs))]


def control(run):
    return _caller(run, encode_kwargs(run, **run.config["control"]))


def check(run, kept: dict) -> dict:
    cfg = run.config
    return check_encode_planned(
        [(run.inputs[i % len(run.inputs)], blob)
         for i, blob in sorted(kept.items())],
        window=cfg["window"], literal=cfg["literal"],
        shard_bytes=run.shard_bytes,
        sample=int(run.traffic["check_shards"]), seed=run.seed)
