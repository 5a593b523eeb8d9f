"""Shared bit-manipulation helpers for the device codec paths.

Shift-safe uint32 idioms: XLA leaves shifts by >= bit-width undefined, so every
variable shift that can reach 32 is expressed as two shifts (``(x >> 1) >>
(31 - s)`` / ``(x << 1) << (31 - s)``).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["extract_window32", "U32"]

U32 = jnp.uint32


def extract_window32(words, pos):
    """32-bit window starting at absolute bit ``pos`` of an MSB-first u32 unit
    stream (the decoder's sliding window, role of the window/next registers in
    `gpuhd/src/cuhd_gpu_decoder.cu:93-117`).

    Args:
      words: (W,) uint32, with at least one zero pad unit past the last data
        unit (so reading unit ``pos//32 + 1`` never overruns — same pad trick
        as `gpuhd/src/cuhd_input_buffer.cc:13-31`).
      pos: integer array of absolute bit offsets (any shape), each in
        [0, 32*(W-1)).

    Returns:
      uint32 array shaped like ``pos``.
    """
    w = (pos >> 5).astype(jnp.int32)
    sh = (pos & 31).astype(U32)
    hi = words[w]
    lo = words[w + 1]
    return (hi << sh) | ((lo >> U32(1)) >> (U32(31) - sh))
