"""Data-parallel encode: gather lengths → prefix-sum bit offsets → vectorized
bit packing, all on device.

JAX redesign of the reference's parallel GPU encoder
(`Huffman_coding_Gap_arrays/encoder/src/encoder.cu:142-355`):

- the reference's warp-shuffle block scans + decoupled-lookback inter-block
  scan (`encoder.cu:192-263`) become one ``jnp.cumsum`` — XLA owns the scan;
- the reference's ``atomicOr`` writes at chunk-boundary words
  (`encoder.cu:322-347`) become a *sorted segmented sum*: each codeword
  contributes to at most two u32 units with disjoint bit ranges, so a
  segment-sum over the sorted unit indices is exactly the OR-merge, with no
  atomics and no races by construction;
- the gap array (`encoder.cu:307-312`) and per-segment symbol counts fall out
  of a vectorized ``searchsorted`` of segment boundaries into the offset
  vector, instead of boundary-crossing detection inside the pack loop.

Everything is static-shape: the payload buffer is padded to ``max_words``
(caller-chosen bound) and the true length is returned as ``total_bits``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .tables import DeviceEncTable

__all__ = ["encode_block", "histogram"]


def histogram(data: jnp.ndarray) -> jnp.ndarray:
    """(256,) int32 byte histogram (role of the reference's warp-privatized
    histogram kernels, `encoder/src/encoder.cu:33-140`; a scatter-add that
    XLA lowers efficiently)."""
    return jnp.zeros(256, jnp.int32).at[data.astype(jnp.int32)].add(1)


@functools.partial(jax.jit, static_argnames=("seg_bits", "max_words", "n_segs"))
def encode_block(
    data: jnp.ndarray,
    enc: DeviceEncTable,
    *,
    seg_bits: int,
    max_words: int,
    n_segs: int,
):
    """Encode one block of bytes into an MSB-first u32 unit stream.

    Args:
      data: (B,) uint8 block.
      enc: device encoder table.
      seg_bits: segment size in bits (power of two).
      max_words: static payload capacity in u32 units; must be >=
        ceil(total_bits/32). The returned buffer has max_words+1 units (one
        zero pad unit, `gpuhd/src/cuhd_input_buffer.cc:13-31` trick).
      n_segs: static segment capacity; must be >= ceil(total_bits/seg_bits).

    Returns:
      words: (max_words+1,) uint32 packed payload (zero beyond total_bits).
      total_bits: () int32 true payload length in bits.
      gaps: (n_segs,) int32; gap[k] = offset in [0,max_len) of the first
        codeword starting in segment k (0 beyond the last segment).
      counts: (n_segs,) int32; codewords starting in segment k.
    """
    data = data.astype(jnp.int32)
    lens = enc.lengths[data]  # (B,) int32
    ends = jnp.cumsum(lens, dtype=jnp.int32)  # inclusive scan
    total_bits = ends[-1]
    offs = ends - lens  # exclusive start bit per codeword

    codes = enc.codes[data]  # (B,) uint32 right-aligned
    left = codes << (32 - lens).astype(jnp.uint32)  # left-justified (lens >= 1)
    sh = (offs & 31).astype(jnp.uint32)
    w0 = offs >> 5
    lo = left >> sh
    # spill into the next unit; == left << (32-sh), 0 when sh == 0
    hi = (left << jnp.uint32(1)) << (jnp.uint32(31) - sh)

    num_units = max_words + 1
    words = jax.ops.segment_sum(
        lo, w0, num_segments=num_units, indices_are_sorted=True
    ) + jax.ops.segment_sum(
        hi, w0 + 1, num_segments=num_units, indices_are_sorted=True
    )
    words = words.astype(jnp.uint32)

    # Per-segment metadata: first codeword start at-or-after each boundary.
    bounds = jnp.arange(n_segs, dtype=jnp.int32) * seg_bits
    idx = jnp.searchsorted(offs, bounds, side="left")
    offs_pad = jnp.concatenate([offs, total_bits[None]])
    gaps = offs_pad[idx] - bounds
    gaps = jnp.where(bounds < total_bits, gaps, 0)
    idx_next = jnp.concatenate([idx[1:], jnp.array([data.shape[0]], idx.dtype)])
    counts = (idx_next - idx).astype(jnp.int32)
    return words, total_bits, gaps.astype(jnp.int32), counts
