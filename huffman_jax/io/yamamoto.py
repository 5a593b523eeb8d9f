"""Yamamoto gap-array container interop (ICPP'20 reference format).

Byte-exact reader/writer for the container produced/consumed by the
reference's `Huffman_coding_Gap_arrays` encoder/decoder pair
(`encoder/src/huff.cpp:186-204` write, `decoder/src/huff.cpp:35-101` read):

    symbol_count   size_t (8 bytes LE)
    symbol_count x (symbol u8, length u8)   # increasing code length; codes
                                            # rebuilt canonically in this
                                            # order (package_merge.cpp:166-181)
    inputfilesize  u32   (original bytes)
    outputfilesize u32   (payload u32 words)
    gap_elements   u32   (= ceil(payload_bits / 128))
    gap array      u32 x ceil(gap_elements / 8)   # 4-bit entries, 8 per u32;
                                                  # element j = entry bit
                                                  # offset of segment j+1
                                                  # (decoder.cu:506)
    payload        u32 x outputfilesize     # MSB-first bit stream

Decoding a foreign container runs ON DEVICE via the framework's two-pass
gap decode (`count_segments` pass-1 + `decode_block`), the same structure
as the reference decoder's count/scan/write pipeline
(`decoder/src/decoder.cu:529-729`).  The format stores no total bit count,
so the count pass uses the word-count upper bound and the last segment's
count is corrected from the known original size.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from ..core.canonical import CodeTable
from ..constants import REF_SEG_BITS
from ..ops.decode import count_segments, decode_block

__all__ = [
    "table_from_length_sequence",
    "write_yamamoto",
    "read_yamamoto",
    "decode_yamamoto",
]

_SEGMENT_BITS = REF_SEG_BITS  # 128, constants.hpp:12
_GAP_PER_WORD = 8  # 4-bit elements per u32, constants.hpp


def table_from_length_sequence(symbols: np.ndarray, lens: np.ndarray) -> CodeTable:
    """Rebuild a CodeTable from a (symbol, length) sequence in canonical file
    order (length ascending, arbitrary tie order).

    The reference ties by its frequency-sort order, not by symbol
    (`package_merge.cpp:104-120`), so the canonical recurrence must run over
    the sequence as given: code_i = (code_{i-1} + 1) << (len_i - len_{i-1}).
    """
    symbols = np.asarray(symbols, np.uint8)
    lens = np.asarray(lens, np.int64)
    if np.any(np.diff(lens) < 0):
        raise ValueError("length sequence not ascending")
    n = symbols.size
    max_len = int(lens.max()) if n else 0
    lengths = np.zeros(256, np.uint8)
    codes = np.zeros(256, np.uint32)
    counts = np.zeros(max_len + 1, np.int32)
    first_code = np.zeros(max_len + 1, np.uint32)
    offsets = np.zeros(max_len + 1, np.int32)
    lim_left = np.zeros(max_len + 1, np.uint32)

    code = 0
    for i in range(n):
        l = int(lens[i])
        if i:
            code = (code + 1) << (l - int(lens[i - 1]))
        lengths[symbols[i]] = l
        codes[symbols[i]] = code
        counts[l] += 1
    if n:
        kraft = int(np.sum(1 << (max_len - lens)))
        if kraft > (1 << max_len):
            raise ValueError("length sequence violates Kraft inequality")
        offsets[1:] = np.cumsum(counts[:-1].astype(np.int64)).astype(np.int32)
        nc = 0
        for l in range(1, max_len + 1):
            first_code[l] = nc
            nc = (nc + int(counts[l])) << 1
        for l in range(1, max_len + 1):
            v = (int(first_code[l]) + int(counts[l])) << (32 - l)
            lim_left[l] = min(v, 0xFFFFFFFF)
    return CodeTable(
        lengths=lengths,
        codes=codes,
        max_len=max(max_len, 1),
        symtab=symbols.copy(),
        counts=counts,
        first_code=first_code,
        offsets=offsets,
        lim_left=lim_left,
    )


def write_yamamoto(data: np.ndarray, table: CodeTable) -> bytes:
    """Encode bytes into a reference-format container (host reference path;
    payload identical to what the reference encoder would emit for the same
    code table)."""
    from ..core import npref

    data = np.asarray(data, np.uint8)
    words, total_bits = npref.encode_bits(data, table)
    words = words[:-1]  # npref appends one pad unit; the format stores exact
    gaps, _, _ = npref.segment_metadata(data, table, _SEGMENT_BITS)
    n_segs = gaps.shape[0]
    # element j = entry offset of segment j+1; the last element is unused.
    elems = np.zeros(n_segs, np.uint32)
    if n_segs > 1:
        elems[: n_segs - 1] = gaps[1:].astype(np.uint32)
    gap_words = np.zeros(-(-n_segs // _GAP_PER_WORD), np.uint32)
    for j in range(_GAP_PER_WORD):
        part = elems[j::_GAP_PER_WORD]
        gap_words[: part.size] |= part << np.uint32(4 * j)

    syms = table.symtab
    lens = table.lengths[syms]
    entries = np.empty((len(syms), 2), np.uint8)
    entries[:, 0] = syms
    entries[:, 1] = lens
    return b"".join(
        [
            struct.pack("<Q", len(syms)),
            entries.tobytes(),
            struct.pack("<III", data.size, words.size, n_segs),
            gap_words.tobytes(),
            words.astype("<u4").tobytes(),
        ]
    )


def read_yamamoto(buf: bytes):
    """Parse a reference-format container.

    Returns (table, words (W,) uint32, gaps (n_segs,) uint8, original_size).
    """
    mv = memoryview(buf)
    if len(buf) < 8:
        raise ValueError("truncated Yamamoto container")
    (symbol_count,) = struct.unpack_from("<Q", mv, 0)
    off = 8
    if symbol_count > 256 or off + 2 * symbol_count + 12 > len(buf):
        raise ValueError("implausible Yamamoto header")
    entries = np.frombuffer(mv, np.uint8, 2 * symbol_count, off).reshape(-1, 2)
    off += 2 * symbol_count
    original_size, n_words, n_segs = struct.unpack_from("<III", mv, off)
    off += 12
    n_gap_words = -(-n_segs // _GAP_PER_WORD)
    if off + 4 * (n_gap_words + n_words) > len(buf):
        raise ValueError("truncated Yamamoto container")
    gap_words = np.frombuffer(mv, np.uint32, n_gap_words, off)
    off += 4 * n_gap_words
    words = np.frombuffer(mv, "<u4", n_words, off).astype(np.uint32)

    table = table_from_length_sequence(entries[:, 0], entries[:, 1].astype(np.int64))
    j = np.arange(n_segs, dtype=np.int64)
    elems = (gap_words[j // _GAP_PER_WORD] >> ((j % _GAP_PER_WORD) * 4)) & 0xF
    gaps = np.zeros(n_segs, np.uint8)
    gaps[1:] = elems[: n_segs - 1].astype(np.uint8)  # decoder.cu:506 indexing
    return table, words, gaps, int(original_size)


def decode_yamamoto(buf: bytes, method: str = "lut") -> np.ndarray:
    """Decode a reference-format container on device (two-pass gap decode:
    the counting pass, then the write pass; ``method`` selects the decode
    step, `ops/decode.py`)."""
    from ..ops import dec_spec, device_dec_table

    table, words, gaps, original_size = read_yamamoto(buf)
    if original_size == 0:
        return np.zeros(0, np.uint8)
    dec = device_dec_table(table, two_level=(method == "twolevel"))
    spec = dec_spec(table)
    n_segs = gaps.shape[0]
    words_j = jnp.asarray(np.concatenate([words, np.zeros(2, np.uint32)]))
    gaps_j = jnp.asarray(gaps.astype(np.int32))
    # The format stores no exact bit count; count against the word-count
    # upper bound, then correct the final segment from the known size.
    max_count = _SEGMENT_BITS // max(spec.min_len, 1) + 1

    counts = count_segments(
        words_j,
        gaps_j,
        jnp.int32(words.size * 32),
        dec,
        spec=spec,
        seg_bits=_SEGMENT_BITS,
        max_count=max_count,
        method=method,
    )
    counts = np.asarray(counts).copy()
    excess = int(counts.sum()) - original_size
    if excess < 0 or excess > counts[-1]:
        raise ValueError("corrupt container: symbol count mismatch")
    counts[-1] -= excess

    out = decode_block(
        words_j,
        gaps_j,
        jnp.asarray(counts),
        dec,
        spec=spec,
        seg_bits=_SEGMENT_BITS,
        max_count=int(counts.max()) if n_segs else 1,
        out_size=original_size,
        method=method,
    )
    return np.asarray(out)
