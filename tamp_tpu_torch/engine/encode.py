"""Tamp stream header (copy of the JAX package's ``engine.encode.build_header``)."""

from __future__ import annotations

__all__ = ["build_header"]


def build_header(
    window: int, literal: int, custom_dictionary: bool, extended: bool,
    dictionary_reset: bool,
) -> list[tuple[int, int]]:
    """Header byte(s) as (value, nbits) fields."""
    header = (
        ((window - 8) << 5)
        | ((literal - 5) << 3)
        | ((1 if custom_dictionary else 0) << 2)
        | ((1 if extended else 0) << 1)
        | (1 if dictionary_reset else 0)
    )
    fields = [(header, 8)]
    if dictionary_reset:
        fields.append((0, 8))  # header byte 2, reserved
    return fields
