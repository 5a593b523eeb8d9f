"""Pure-NumPy reference codec — the test oracle.

Slow-but-obviously-correct implementations of the exact bit format the device
codecs produce, playing the role the reference's `sequential.cpp` plays for
its parallel variants (the de-facto oracle, SURVEY §4).  Bit semantics match
the reference GPU codecs: codes are packed MSB-first into uint32 units
(`Huffman_coding_Gap_arrays/encoder/src/encoder.cu:279-347` accumulates via
``window = (window << len) | code``), and each segment's gap element is the
bit offset (< max_len) of the first codeword starting at-or-after the segment
boundary (`encoder.cu:307-312`).
"""

from __future__ import annotations

import numpy as np

from ..constants import ALPHABET_SIZE, SEG_BITS, UNIT_BITS
from .canonical import CodeTable, build_flat_lut

__all__ = [
    "histogram",
    "encode_bits",
    "segment_metadata",
    "decode_bits_serial",
    "decode_segments_np",
]


def histogram(data: np.ndarray) -> np.ndarray:
    """(256,) int64 byte histogram (role of `encoder/src/encoder.cu:33-140`;
    OpenMP native path mirrors `parallel_cpu.cpp:130-169`)."""
    data = np.asarray(data, dtype=np.uint8)
    from .. import native

    if native.available() and data.size >= (1 << 16):
        return native.histogram(data)
    return np.bincount(data, minlength=ALPHABET_SIZE).astype(np.int64)


def encode_bits(data: np.ndarray, table: CodeTable):
    """Encode bytes into an MSB-first uint32 unit stream.

    Returns (words, total_bits).  ``words`` has one zero pad unit appended so
    decoders may read one unit past the end (same trick as the reference's
    `CUHDInputBuffer`, `gpuhd/src/cuhd_input_buffer.cc:13-31`).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.zeros(1, np.uint32), 0

    from .. import native

    if native.available():
        if np.any(table.lengths[np.unique(data)] == 0):
            raise ValueError("input contains a symbol absent from the code table")
        return native.encode_bits(data, table.codes, table.lengths)

    lens = table.lengths[data].astype(np.int64)
    if np.any(lens == 0):
        raise ValueError("input contains a symbol absent from the code table")
    codes = table.codes[data].astype(np.uint64)

    ends = np.cumsum(lens)
    total_bits = int(ends[-1])
    offs = ends - lens  # exclusive start bit of each codeword

    n_words = (total_bits + UNIT_BITS - 1) // UNIT_BITS
    words = np.zeros(n_words + 1, np.uint32)

    left = (codes << (64 - lens).astype(np.uint64)).astype(np.uint64)  # left-justified
    sh = (offs % UNIT_BITS).astype(np.uint64)
    w0 = (offs // UNIT_BITS).astype(np.int64)
    both = left >> sh  # top 32 bits -> word w0, next 32 -> word w0+1
    lo = (both >> np.uint64(32)).astype(np.uint32)
    hi = (both & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    np.add.at(words, w0, lo)  # disjoint bit ranges: add == or
    np.add.at(words, w0 + 1, hi)
    return words, total_bits


def segment_metadata(data: np.ndarray, table: CodeTable, seg_bits: int = SEG_BITS):
    """Per-segment (gap, count) metadata.

    gap[k] = bit offset within segment k of the first codeword starting in it
    (0 for segment 0; < max_len always).  count[k] = number of codewords
    starting inside segment k.  Segment k covers bits [k*seg_bits,
    (k+1)*seg_bits).
    """
    data = np.asarray(data, dtype=np.uint8)
    lens = table.lengths[data].astype(np.int64)
    ends = np.cumsum(lens)
    total_bits = int(ends[-1]) if data.size else 0
    offs = ends - lens
    n_segs = max((total_bits + seg_bits - 1) // seg_bits, 0)
    bounds = np.arange(n_segs, dtype=np.int64) * seg_bits
    idx = np.searchsorted(offs, bounds, side="left")
    offs_pad = np.concatenate([offs, [total_bits]])
    gaps = (offs_pad[idx] - bounds).astype(np.int64)
    gaps = np.where(bounds < total_bits, gaps, 0)
    idx_next = np.concatenate([idx[1:], [data.size]])
    counts = (idx_next - idx).astype(np.int64)
    return gaps.astype(np.uint8), counts.astype(np.int32), total_bits


def decode_bits_serial(
    words: np.ndarray, total_bits: int, table: CodeTable, n_symbols: int | None = None
) -> np.ndarray:
    """Bit-serial decode via the flat LUT — the trusted slow path.

    Mirrors the shape of the reference's window/LUT loop
    (`gpuhd/src/cuhd_gpu_decoder.cu:91-139`) at oracle speed.
    """
    b = table.max_len_present
    if b == 0:
        return np.zeros(0, np.uint8)
    lut_sym, lut_len = build_flat_lut(table, b)
    bits = np.unpackbits(
        np.ascontiguousarray(words[: (total_bits + 31) // 32]).view(np.uint8).reshape(-1, 4)[:, ::-1]
    )
    out = []
    pos = 0
    # pad bits so a full window read never overruns
    bits = np.concatenate([bits[:total_bits], np.zeros(b, np.uint8)])
    weights = 1 << np.arange(b - 1, -1, -1)
    while pos < total_bits:
        window = int(bits[pos : pos + b] @ weights)
        l = int(lut_len[window])
        out.append(lut_sym[window])
        pos += l
        if l == 0:
            raise ValueError("corrupt stream: zero-length code")
    res = np.asarray(out, np.uint8)
    if n_symbols is not None and res.size != n_symbols:
        raise ValueError(f"decoded {res.size} symbols, expected {n_symbols}")
    return res


def decode_segments_np(
    words: np.ndarray,
    gaps: np.ndarray,
    counts: np.ndarray,
    table: CodeTable,
    seg_bits: int = SEG_BITS,
) -> np.ndarray:
    """Vectorized-across-segments NumPy decode (mirrors the device algorithm).

    All segments advance in lock-step, one symbol per step, exactly like the
    device decoder — used to validate the algorithm independent of JAX.
    """
    b = table.max_len_present
    lut_sym, lut_len = build_flat_lut(table, b)
    n_segs = len(gaps)
    if n_segs == 0:
        return np.zeros(0, np.uint8)
    words64 = words.astype(np.uint64)
    words64 = np.concatenate([words64, np.zeros(1, np.uint64)])

    pos = np.arange(n_segs, dtype=np.int64) * seg_bits + gaps.astype(np.int64)
    remaining = counts.astype(np.int64).copy()
    out_cols = []
    max_count = int(remaining.max()) if n_segs else 0
    for _ in range(max_count):
        active = remaining > 0
        w = pos >> 5
        sh = (pos & 31).astype(np.uint64)
        window = ((words64[w] << np.uint64(32)) | words64[w + 1]) >> (
            np.uint64(32) - sh
        )
        window = (window & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        idx = (window >> np.uint32(32 - b)).astype(np.int64)
        sym = lut_sym[idx]
        ln = lut_len[idx].astype(np.int64)
        out_cols.append(np.where(active, sym, 0).astype(np.uint8))
        pos += np.where(active, ln, 0)
        remaining -= active.astype(np.int64)

    padded = np.stack(out_cols, axis=0) if out_cols else np.zeros((0, n_segs), np.uint8)
    total = int(counts.sum())
    out_offs = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    k = np.arange(total, dtype=np.int64)
    seg_id = np.searchsorted(out_offs, k, side="right") - 1
    t = k - out_offs[seg_id]
    return padded[t, seg_id]
