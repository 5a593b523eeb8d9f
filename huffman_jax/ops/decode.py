"""Gap-array data-parallel decode, pure XLA.

JAX redesign of the gap-array decoder
(`Huffman_coding_Gap_arrays/decoder/src/decoder.cu:454-730`):

- *one segment per vector lane* instead of one per CUDA thread: all segments
  advance in lock-step, one codeword per step, with masked completion — the
  decode loop is a ``lax.scan`` whose per-step body is pure vector math over
  every segment at once;
- the reference's two passes (count, then re-decode and write at
  prefix-summed offsets, `decoder.cu:529-569` + `:655-729`) collapse to ONE
  pass in our native container because the encoder already recorded
  per-segment symbol counts: output placement is a ``cumsum`` of known counts
  plus a gather-based compaction, never an atomicOr;
- a two-pass mode (`count_segments`) remains for reference-format streams
  that carry gaps only.

Decode step uses the flat LUT (one gather per step), canonical limit
arithmetic (<=15 compares, no big LUT), or the reference's two-level L1/L2
probe (`get_table.cpp:48-139` + `decoder.cu:529-569`) — selected by
``method``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .bitops import extract_window32
from .tables import DecSpec, DeviceDecTable

__all__ = ["decode_block", "count_segments"]


def _decode_step(window, dec: DeviceDecTable, spec: DecSpec, method: str):
    """One codeword from each 32-bit window: returns (symbol int32, len int32)."""
    if method == "lut":
        idx = (window >> jnp.uint32(32 - spec.lut_bits)).astype(jnp.int32)
        return dec.lut_sym[idx], dec.lut_len[idx]
    elif method == "canonical":
        # length = 1 + #{l in [1, max_len-1] : window >= lim_left[l]}
        ln = jnp.ones_like(window, jnp.int32)
        for l in range(1, spec.max_len):
            ln = ln + (window >= dec.lim_left[l]).astype(jnp.int32)
        shift = (jnp.int32(32) - ln).astype(jnp.uint32)
        value = (window >> shift).astype(jnp.int32)
        rank = dec.offsets[ln] + value - dec.first_code[ln].astype(jnp.int32)
        return dec.symtab[rank], ln
    elif method == "twolevel":
        # the reference's gpu_dec_l1_l2 probe (`decoder.cu:529-569`): short
        # codes resolve in the 2^p L1; a long code's p-bit prefix indexes
        # ptr_tab for its L2 subtable (width << 16 | offset) and the NEXT
        # `width` bits select within it
        p = spec.prefix_bits
        if p <= 0 or dec.l1_sym.shape[0] != (1 << p):
            raise ValueError(
                "decode table lacks the two-level form; build it with "
                "device_dec_table(table, two_level=True)"
            )
        idx1 = (window >> jnp.uint32(32 - p)).astype(jnp.int32)
        s1, l1 = dec.l1_sym[idx1], dec.l1_len[idx1]
        is_long = idx1 >= spec.l1_boundary
        pidx = jnp.clip(idx1 - spec.l1_boundary, 0, dec.ptr_tab.shape[0] - 1)
        ptr = dec.ptr_tab[pidx]
        width = (ptr >> jnp.uint32(16)).astype(jnp.uint32)
        off = (ptr & jnp.uint32(0xFFFF)).astype(jnp.int32)
        sub = window << jnp.uint32(p)
        # width may be 0 (pad/unused prefix): guarded >=32-safe shift
        v2 = ((sub >> jnp.uint32(1)) >> (jnp.uint32(31) - width)).astype(
            jnp.int32
        )
        idx2 = jnp.clip(off + v2, 0, dec.l2_sym.shape[0] - 1)
        s2, l2 = dec.l2_sym[idx2], dec.l2_len[idx2]
        return jnp.where(is_long, s2, s1), jnp.where(is_long, l2, l1)
    raise ValueError(f"unknown decode method: {method}")


@functools.partial(
    jax.jit,
    static_argnames=("spec", "seg_bits", "max_count", "out_size", "method"),
)
def decode_block(
    words: jnp.ndarray,
    gaps: jnp.ndarray,
    counts: jnp.ndarray,
    dec: DeviceDecTable,
    *,
    spec: DecSpec,
    seg_bits: int,
    max_count: int,
    out_size: int,
    method: str = "lut",
):
    """One-pass decode of a block given per-segment (gap, count) metadata.

    Args:
      words: (W,) uint32 payload with >= 1 zero pad unit at the end.
      gaps: (S,) int32 entry bit offset per segment.
      counts: (S,) int32 codewords starting per segment (sum == out_size).
      spec: static decode config.
      seg_bits: segment size in bits.
      max_count: static bound >= max(counts) (scan trip count).
      out_size: static decoded size in bytes.
      method: "lut" | "canonical" | "twolevel".

    Returns:
      (out_size,) uint8 decoded bytes.
    """
    s = gaps.shape[0]
    pos0 = jnp.arange(s, dtype=jnp.int32) * seg_bits + gaps

    def step(carry, _):
        pos, rem = carry
        window = extract_window32(words, pos)
        sym, ln = _decode_step(window, dec, spec, method)
        active = rem > 0
        pos = pos + jnp.where(active, ln, 0)
        rem = rem - active.astype(jnp.int32)
        out = jnp.where(active, sym, 0).astype(jnp.uint8)
        return (pos, rem), out

    (_, _), cols = jax.lax.scan(
        step, (pos0, counts.astype(jnp.int32)), None, length=max_count
    )
    # cols: (max_count, S). Compact to original order: symbol k of the stream
    # is step (k - out_offs[seg]) of segment seg.  Segment ids come from a
    # scatter+cumsum expand (cheaper than a searchsorted over the full
    # output at 10^8 queries).
    out_offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    marks = jnp.zeros(out_size, jnp.int32).at[out_offs[:-1]].add(
        1, mode="drop", indices_are_sorted=True
    )
    seg_id = jnp.cumsum(marks, dtype=jnp.int32) - 1
    k = jnp.arange(out_size, dtype=jnp.int32)
    t = k - out_offs[seg_id]
    return cols[t, seg_id]


@functools.partial(
    jax.jit, static_argnames=("spec", "seg_bits", "max_count", "method")
)
def count_segments(
    words: jnp.ndarray,
    gaps: jnp.ndarray,
    total_bits: jnp.ndarray,
    dec: DeviceDecTable,
    *,
    spec: DecSpec,
    seg_bits: int,
    max_count: int,
    method: str = "lut",
):
    """Pass-1 symbol counting for gap-only streams (reference-format parity;
    role of the counting pass `decoder/src/decoder.cu:529-569`).

    Decodes each segment from its gap to the next segment's first-codeword
    start (both known from the gap array alone) counting codewords.

    Returns (S,) int32 counts.
    """
    s = gaps.shape[0]
    starts = jnp.arange(s, dtype=jnp.int32) * seg_bits + gaps
    seg_ends = jnp.concatenate([starts[1:], total_bits.astype(jnp.int32)[None]])
    seg_ends = jnp.minimum(seg_ends, total_bits.astype(jnp.int32))

    def step(carry, _):
        pos, cnt = carry
        window = extract_window32(words, pos)
        if method == "canonical":
            # counting needs lengths only: the pure compare chain, no
            # symbol gathers at all
            ln = jnp.ones_like(window, jnp.int32) * spec.min_len
            chain = spec.chain or tuple(
                (l, 1) for l in range(spec.min_len, spec.max_len)
            )
            for (l, wt) in chain:
                ln = ln + jnp.where(window >= dec.lim_left[l], wt, 0)
        else:
            _, ln = _decode_step(window, dec, spec, method)
        active = pos < seg_ends
        pos = pos + jnp.where(active, ln, 0)
        cnt = cnt + active.astype(jnp.int32)
        return (pos, cnt), None

    (_, counts), _ = jax.lax.scan(
        step, (starts, jnp.zeros(s, jnp.int32)), None, length=max_count
    )
    return counts
