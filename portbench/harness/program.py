"""The configuration's settings as the port's container API takes them."""

from __future__ import annotations

__all__ = ["encode_kwargs"]


def encode_kwargs(run, **over) -> dict:
    """``compress_sharded``'s keywords for the run's configuration and
    shard size (``over`` replaces some: a control's)."""
    cfg = run.config
    kw = dict(window=cfg["window"], literal=cfg["literal"],
              extended=cfg["extended"], lazy_matching=cfg["lazy_matching"],
              engine=cfg["engine"], shard_size=run.shard_bytes,
              device=run.prog_device)
    if cfg.get("dictionary", "default") != "default":
        raise ValueError("the benchmark's configurations use the default "
                         "dictionary")
    kw.update(over)
    return kw
