"""Tamp stream header, v1 window model and the host bit stitch.

``build_header`` and ``model_history`` are copies of the JAX package's
``engine.encode``; :func:`bits_to_bytes` finishes a stream behind a commit
kernel's bit remainder."""

from __future__ import annotations

import numpy as np

from ..dictionary import dictionary_array

__all__ = ["build_header", "model_history", "bits_to_bytes"]


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


def model_history(data: np.ndarray, window: int, literal: int,
                  extended: bool, dictionary):
    """``(initial window, C = initial window || data)``: the v1
    window-write history model."""
    if dictionary is not None:
        dict_arr = np.frombuffer(bytes(dictionary), dtype=np.uint8)
        if dict_arr.shape[0] != (1 << window):
            raise ValueError("Dictionary-window size mismatch.")
    else:
        # v1 compatibility quirk: non-extended streams always seed with
        # literal=8 (spec: specification.rst "Dictionary Initialization").
        dict_arr = dictionary_array(1 << window,
                                    literal=literal if extended else 8)
    return dict_arr, np.concatenate([dict_arr, data])


def bits_to_bytes(fields, acc: int, an: int) -> bytes:
    """Push ``(value, nbits)`` fields behind the ``an``-bit remainder
    ``acc``, MSB-first, and zero-pad the final partial byte."""
    out = bytearray()
    for v, nb in list(fields) + [(0, 0)]:  # the empty field drains acc
        acc = (acc << nb) | v
        an += nb
        while an >= 8:
            out.append((acc >> (an - 8)) & 0xFF)
            an -= 8
            acc &= (1 << an) - 1
    if an:
        out.append((acc << (8 - an)) & 0xFF)
    return bytes(out)
