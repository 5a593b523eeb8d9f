"""Canonical Huffman code assignment and decode-table construction.

Host-side table math (NumPy).  Covers the roles of:

- canonical code assignment from sorted lengths
  (`gpuhd/encoder/src/llhuffman_encoder.cc:160-198`,
  `Huffman_coding_Gap_arrays/encoder/src/package_merge.cpp:166-181`);
- single-level 2^L decode LUT expansion
  (`gpuhd/encoder/src/llhuffman_encoder.cc:240-262`);
- two-level L1/L2 prefix decode tables
  (`Huffman_coding_Gap_arrays/decoder/src/get_table.cpp:3-139`);
- plus the *canonical-arithmetic* decoder arrays (limit/base/offset) that the
  ILS kernels use instead of a big LUT gather: code length is recovered with
  at most 15 compares (`len = 1 + sum(window >= lim[l])`) and the symbol with
  one small gather, all in registers (the role of the reference's
  per-thread LUT probe, `cuhd_gpu_decoder.cu:93-117`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import ALPHABET_SIZE, MAX_CODEWORD_LENGTH

__all__ = [
    "CodeTable",
    "canonical_code_table",
    "build_flat_lut",
    "build_two_level_table",
    "TwoLevelTable",
]


@dataclasses.dataclass(frozen=True)
class CodeTable:
    """Canonical Huffman code table (host-side, NumPy arrays).

    Attributes:
      lengths: (256,) uint8 codeword length per symbol; 0 = absent.
      codes: (256,) uint32 right-aligned canonical codeword per symbol.
      max_len: the L the table was built for (codeword lengths are <= L).
      symtab: (n,) uint8 symbols in canonical order (length asc, symbol asc).
      counts: (L+1,) int32 number of codes of each length (index = length).
      first_code: (L+1,) uint32 first canonical code value of each length.
      offsets: (L+1,) int32 rank (index into symtab) of the first symbol of
        each length.
      lim_left: (L+1,) uint32 left-justified decode limits; for a 32-bit
        window, true length = 1 + #{l in [1, L-1] : window >= lim_left[l]}.
    """

    lengths: np.ndarray
    codes: np.ndarray
    max_len: int
    symtab: np.ndarray
    counts: np.ndarray
    first_code: np.ndarray
    offsets: np.ndarray
    lim_left: np.ndarray

    @property
    def num_symbols(self) -> int:
        return int(self.symtab.shape[0])

    @property
    def min_len(self) -> int:
        present = self.lengths[self.lengths > 0]
        return int(present.min()) if present.size else 0

    @property
    def max_len_present(self) -> int:
        present = self.lengths[self.lengths > 0]
        return int(present.max()) if present.size else 0


def canonical_code_table(
    lengths: np.ndarray, max_len: int = MAX_CODEWORD_LENGTH
) -> CodeTable:
    """Assign canonical codes from a valid length profile.

    Canonical order is (length ascending, symbol ascending); codes within the
    order are ``code[i] = (code[i-1] + 1) << (len[i] - len[i-1])`` — the same
    recurrence as the reference (`llhuffman_encoder.cc:183-195`).
    """
    lengths = np.asarray(lengths, dtype=np.uint8)
    if lengths.shape != (ALPHABET_SIZE,):
        raise ValueError("lengths must be shape (256,)")
    if int(lengths.max(initial=0)) > max_len:
        raise ValueError("length exceeds max_len")

    syms = np.nonzero(lengths > 0)[0]
    ls = lengths[syms].astype(np.int64)
    order = np.lexsort((syms, ls))
    symtab = syms[order].astype(np.uint8)
    sorted_lens = ls[order]

    codes = np.zeros(ALPHABET_SIZE, np.uint32)
    counts = np.zeros(max_len + 1, np.int32)
    first_code = np.zeros(max_len + 1, np.uint32)
    offsets = np.zeros(max_len + 1, np.int32)
    lim_left = np.zeros(max_len + 1, np.uint32)

    if len(symtab) > 0:
        # Kraft check
        kraft = int(np.sum(1 << (max_len - sorted_lens)))
        if kraft > (1 << max_len):
            raise ValueError("lengths violate Kraft inequality")

        c = 0
        prev = int(sorted_lens[0])
        codes[symtab[0]] = 0
        for i in range(1, len(symtab)):
            l = int(sorted_lens[i])
            c = (c + 1) << (l - prev)
            prev = l
            codes[symtab[i]] = c

        for l in range(1, max_len + 1):
            counts[l] = int(np.sum(sorted_lens == l))
        offsets[1:] = np.cumsum(counts[:-1].astype(np.int64))[:].astype(np.int32)
        # first canonical code per length: next_code recurrence
        nc = 0
        for l in range(1, max_len + 1):
            first_code[l] = nc
            nc = (nc + int(counts[l])) << 1
        # left-justified limits (first_code + count) << (32 - l); only levels
        # strictly below the deepest occupied level are ever compared, so the
        # 2^32 overflow at a saturated deepest level never materializes — we
        # clamp to 0xFFFFFFFF defensively.
        for l in range(1, max_len + 1):
            v = (int(first_code[l]) + int(counts[l])) << (32 - l)
            lim_left[l] = min(v, 0xFFFFFFFF)

    return CodeTable(
        lengths=lengths,
        codes=codes,
        max_len=max_len,
        symtab=symtab,
        counts=counts,
        first_code=first_code,
        offsets=offsets,
        lim_left=lim_left,
    )


def chain_spec(table: CodeTable) -> tuple[tuple[int, int], ...]:
    """Grouped compare-chain spec for the canonical length decode.

    The dense decode formula is ``len = min_len + #{l in [min_len,
    max_len_present) : window >= lim_left[l]}``.  Consecutive levels with
    no codewords share the SAME left-justified limit (``lim_left[l] ==
    lim_left[l+1]`` iff ``counts[l+1] == 0``, from the next_code
    recurrence), so their compares are duplicates.  This returns one
    ``(level, weight)`` pair per DISTINCT limit — ``len = min_len +
    sum(weight for (l, w) where window >= lim_left[l])`` — which the decode
    kernel evaluates with one compare per group (typical tables have 2-4
    groups vs up to 15 dense levels).  Derived from counts only, so the
    decoder reconstructs the identical spec from the container's lengths.
    """
    lo, hi = table.min_len, table.max_len_present
    out = []
    l = lo
    while l < hi:
        j = l
        while j + 1 < hi and int(table.counts[j + 1]) == 0:
            j += 1
        out.append((j, j - l + 1))
        l = j + 1
    return tuple(out)


def build_flat_lut(table: CodeTable, lut_bits: int | None = None):
    """Single-level decode LUT: 2^lut_bits entries of (symbol, length).

    Every codeword of length l fills ``2**(lut_bits-l)`` consecutive rows —
    same expansion as `llhuffman_encoder.cc:240-262`, built vectorized.

    Returns (lut_sym (2^B,) uint8, lut_len (2^B,) uint8).
    """
    b = int(lut_bits if lut_bits is not None else table.max_len)
    if table.max_len_present > b:
        raise ValueError("lut_bits smaller than longest codeword")
    size = 1 << b
    lut_sym = np.zeros(size, np.uint8)
    lut_len = np.zeros(size, np.uint8)
    syms = table.symtab
    if syms.size == 0:
        return lut_sym, lut_len
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)
    starts = cs << (b - ls)
    widths = (np.int64(1) << (b - ls)).astype(np.int64)
    reps = np.repeat(np.arange(len(syms)), widths)
    idx = np.repeat(starts, widths) + _ranges(widths)
    lut_sym[idx] = syms[reps]
    lut_len[idx] = ls[reps].astype(np.uint8)
    return lut_sym, lut_len


def _ranges(widths: np.ndarray) -> np.ndarray:
    """Concatenated [0..w) ranges for each w in widths (vectorized)."""
    total = int(widths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(widths)
    starts = ends - widths
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(starts, widths)
    return out


@dataclasses.dataclass(frozen=True)
class TwoLevelTable:
    """Two-level L1/L2 decode table (format parity with
    `Huffman_coding_Gap_arrays/decoder/src/get_table.cpp:48-139`).

    Short codes (len <= prefix_bits) replicate into the L1 table; longer codes
    group by their prefix_bits-bit prefix into per-prefix L2 subtables whose
    width is (longest code sharing the prefix) - prefix_bits.
    """

    prefix_bits: int
    boundary_code: int  # first L1 index owned by long codes
    l1_sym: np.ndarray  # (2^prefix_bits,) uint8
    l1_len: np.ndarray  # (2^prefix_bits,) uint8
    ptr_table: np.ndarray  # (n_long_prefixes,) uint32: (width << 16) | offset
    l2_sym: np.ndarray  # (l2_size,) uint8
    l2_len: np.ndarray  # (l2_size,) uint8


def build_two_level_table(table: CodeTable, prefix_bits: int = 10) -> TwoLevelTable:
    maxl = table.max_len_present
    p = int(prefix_bits)
    l1_size = 1 << p
    l1_sym = np.zeros(l1_size, np.uint8)
    l1_len = np.zeros(l1_size, np.uint8)

    syms = table.symtab
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)

    short = ls <= p
    if np.any(short):
        starts = cs[short] << (p - ls[short])
        widths = np.int64(1) << (p - ls[short])
        idx = np.repeat(starts, widths) + _ranges(widths)
        reps = np.repeat(np.arange(int(short.sum())), widths)
        l1_sym[idx] = syms[short][reps]
        l1_len[idx] = ls[short][reps].astype(np.uint8)

    # boundary_code: first p-bit prefix owned by long codes. Canonical order
    # means all long-code prefixes are >= every short-code L1 index.
    if np.any(~short):
        long_prefix = (cs[~short] >> (ls[~short] - p)).astype(np.int64)
        boundary = int(long_prefix.min())
        prefixes = np.unique(long_prefix)
        ptr_entries = []
        l2_sym_parts = []
        l2_len_parts = []
        off = 0
        # one subtable per distinct long prefix, in ascending prefix order;
        # prefixes between boundary and max prefix that are unused get
        # zero-width entries so indexing stays (prefix - boundary).
        max_prefix = int(prefixes.max())
        for pref in range(boundary, max_prefix + 1):
            sel = long_prefix == pref
            if not np.any(sel):
                ptr_entries.append((0 << 16) | off)
                continue
            sub_ls = ls[~short][sel]
            sub_cs = cs[~short][sel]
            sub_syms = syms[~short][sel]
            width = int(sub_ls.max()) - p
            size = 1 << width
            ssym = np.zeros(size, np.uint8)
            slen = np.zeros(size, np.uint8)
            starts = (sub_cs & ((np.int64(1) << (sub_ls - p)) - 1)) << (
                p + width - sub_ls
            )
            widths = np.int64(1) << (p + width - sub_ls)
            idx = np.repeat(starts, widths) + _ranges(widths)
            reps = np.repeat(np.arange(len(sub_syms)), widths)
            ssym[idx] = sub_syms[reps]
            slen[idx] = sub_ls[reps].astype(np.uint8)
            ptr_entries.append((width << 16) | off)
            l2_sym_parts.append(ssym)
            l2_len_parts.append(slen)
            off += size
        ptr_table = np.asarray(ptr_entries, np.uint32)
        l2_sym = (
            np.concatenate(l2_sym_parts) if l2_sym_parts else np.zeros(0, np.uint8)
        )
        l2_len = (
            np.concatenate(l2_len_parts) if l2_len_parts else np.zeros(0, np.uint8)
        )
    else:
        boundary = l1_size
        ptr_table = np.zeros(0, np.uint32)
        l2_sym = np.zeros(0, np.uint8)
        l2_len = np.zeros(0, np.uint8)

    del maxl
    return TwoLevelTable(
        prefix_bits=p,
        boundary_code=boundary,
        l1_sym=l1_sym,
        l1_len=l1_len,
        ptr_table=ptr_table,
        l2_sym=l2_sym,
        l2_len=l2_len,
    )
