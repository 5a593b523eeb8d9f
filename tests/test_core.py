"""Core table-construction and NumPy-oracle tests (no JAX)."""

import numpy as np
import pytest

from huffman_jax.core import (
    package_merge_lengths,
    huffman_lengths_unbounded,
    kraft_sum,
    canonical_code_table,
    build_flat_lut,
    build_two_level_table,
)
from huffman_jax.core import npref
from huffman_jax.utils import generate_redundant, generate_binomial


def entropy_bits(freqs):
    f = freqs[freqs > 0].astype(np.float64)
    p = f / f.sum()
    return float(-(p * np.log2(p)).sum() * f.sum())


@pytest.mark.parametrize("redundancy", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("max_len", [11, 16])
def test_package_merge_valid_and_near_optimal(redundancy, max_len):
    data = generate_redundant(200_000, redundancy, seed=1)
    freqs = npref.histogram(data)
    lengths = package_merge_lengths(freqs, max_len)
    present = freqs > 0
    assert np.all(lengths[present] >= 1)
    assert np.all(lengths[present] <= max_len)
    assert np.all(lengths[~present] == 0)
    # Kraft equality for an optimal complete code with >= 2 symbols
    assert abs(kraft_sum(lengths) - 1.0) < 1e-12
    # cost within a tiny factor of entropy + 1 bit/symbol bound
    cost = int((lengths.astype(np.int64) * freqs).sum())
    h = entropy_bits(freqs)
    assert cost <= h + data.size + 1


def test_package_merge_matches_unbounded_when_depth_fits():
    # binomial data: greedy tree depth can exceed 16, so use moderate skew
    data = generate_redundant(100_000, 0.5, seed=2)
    freqs = npref.histogram(data)
    greedy = huffman_lengths_unbounded(freqs)
    if int(greedy.max()) <= 16:
        pm = package_merge_lengths(freqs, 16)
        cost_pm = int((pm.astype(np.int64) * freqs).sum())
        cost_greedy = int((greedy.astype(np.int64) * freqs).sum())
        assert cost_pm == cost_greedy  # both optimal


def test_package_merge_monotone():
    freqs = np.zeros(256, np.int64)
    freqs[:8] = [1, 2, 4, 8, 16, 32, 64, 128]
    lengths = package_merge_lengths(freqs, 16)
    ls = lengths[:8].astype(int)
    assert all(ls[i] >= ls[i + 1] for i in range(7))


def test_package_merge_edge_cases():
    freqs = np.zeros(256, np.int64)
    assert np.all(package_merge_lengths(freqs) == 0)
    freqs[65] = 100
    lengths = package_merge_lengths(freqs)
    assert lengths[65] == 1 and lengths.sum() == 1
    freqs[66] = 1
    lengths = package_merge_lengths(freqs)
    assert lengths[65] == 1 and lengths[66] == 1
    # all 256 symbols at max_len=8 forces the fixed 8-bit code
    freqs = np.arange(1, 257, dtype=np.int64)
    lengths = package_merge_lengths(freqs, 8)
    assert np.all(lengths == 8)
    with pytest.raises(ValueError):
        package_merge_lengths(freqs, 7)


def test_canonical_codes_prefix_free():
    data = generate_binomial(50_000, seed=3)
    freqs = npref.histogram(data)
    lengths = package_merge_lengths(freqs, 16)
    table = canonical_code_table(lengths, 16)
    syms = table.symtab
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)
    # left-justified intervals must be disjoint and sorted
    starts = cs << (32 - ls)
    ends = (cs + 1) << (32 - ls)
    order = np.argsort(starts)
    assert np.all(ends[order][:-1] <= starts[order][1:])
    # canonical: codes ascend in (length, symbol) order
    lj = starts[np.lexsort((syms, ls))]
    assert np.all(np.diff(lj) > 0)


def test_flat_lut_roundtrip_properties():
    data = generate_redundant(50_000, 0.5, seed=4)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    b = table.max_len_present
    lut_sym, lut_len = build_flat_lut(table, b)
    assert np.all(lut_len >= 1)  # complete code fills the whole LUT
    # probing with each codeword's left-justified value returns the symbol
    for sym in table.symtab[:50]:
        l = int(table.lengths[sym])
        c = int(table.codes[sym])
        idx = c << (b - l)
        assert lut_sym[idx] == sym
        assert lut_len[idx] == l


def test_limit_decode_equivalent_to_lut():
    data = generate_binomial(50_000, seed=5)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    b = table.max_len_present
    lut_sym, lut_len = build_flat_lut(table, b)
    rng = np.random.default_rng(6)
    windows = rng.integers(0, 1 << 32, size=2000, dtype=np.uint64).astype(np.uint32)
    # limit-based length: 1 + #{l in [1, maxlen-1]: window >= lim[l]}
    lims = table.lim_left[1:b].astype(np.uint64)
    lens = 1 + (windows.astype(np.uint64)[:, None] >= lims[None, :]).sum(axis=1)
    idx = (windows >> np.uint32(32 - b)).astype(np.int64)
    assert np.array_equal(lens, lut_len[idx].astype(np.int64))
    # rank -> symbol
    fc = table.first_code.astype(np.int64)
    offs = table.offsets.astype(np.int64)
    ranks = offs[lens] + (windows >> (32 - lens).astype(np.uint32)).astype(
        np.int64
    ) - fc[lens]
    assert np.array_equal(table.symtab[ranks], lut_sym[idx])


def test_two_level_table_matches_flat_lut():
    data = generate_binomial(50_000, seed=7)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    b = table.max_len_present
    tl = build_two_level_table(table, prefix_bits=10)
    lut_sym, lut_len = build_flat_lut(table, b)
    rng = np.random.default_rng(8)
    windows = rng.integers(0, 1 << 32, size=2000, dtype=np.uint64).astype(np.uint32)
    for w in windows[:500]:
        w = int(w)
        pref = w >> (32 - tl.prefix_bits)
        if pref < tl.boundary_code:
            sym, ln = tl.l1_sym[pref], tl.l1_len[pref]
        else:
            entry = int(tl.ptr_table[pref - tl.boundary_code])
            width = entry >> 16
            off = entry & 0xFFFF
            sub = (w >> (32 - tl.prefix_bits - width)) & ((1 << width) - 1)
            sym, ln = tl.l2_sym[off + sub], tl.l2_len[off + sub]
        idx = w >> (32 - b)
        assert sym == lut_sym[idx] and ln == lut_len[idx]


def test_dec_spec_boundary_matches_two_level_builder():
    # dec_spec computes the L1 boundary without building L2 arrays; pin the
    # cheap form to the full builder across table shapes
    from huffman_jax.ops.tables import _two_level_prefix, dec_spec

    cases = [
        generate_binomial(50_000, seed=13),
        generate_redundant(50_000, 0.9, seed=14),
        np.full(1000, 7, np.uint8),  # single symbol, no long codes
        np.arange(256, dtype=np.uint8).repeat(4),  # uniform 8-bit codes
    ]
    for data in cases:
        table = canonical_code_table(
            package_merge_lengths(npref.histogram(data), 16), 16
        )
        p = _two_level_prefix(table)
        tl = build_two_level_table(table, p)
        assert dec_spec(table).l1_boundary == int(tl.boundary_code)


@pytest.mark.parametrize("gen,seed", [("red0.5", 9), ("red0.9", 10), ("binom", 11)])
def test_npref_roundtrip(gen, seed):
    if gen == "binom":
        data = generate_binomial(30_000, seed=seed)
    else:
        data = generate_redundant(30_000, float(gen[3:]), seed=seed)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    words, total_bits = npref.encode_bits(data, table)
    decoded = npref.decode_bits_serial(words, total_bits, table, n_symbols=data.size)
    np.testing.assert_array_equal(decoded, data)


def test_npref_segment_decode_matches_serial():
    data = generate_redundant(30_000, 0.5, seed=12)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    words, total_bits = npref.encode_bits(data, table)
    gaps, counts, tb = npref.segment_metadata(data, table, seg_bits=1024)
    assert tb == total_bits
    assert int(counts.sum()) == data.size
    assert np.all(gaps < 16)
    decoded = npref.decode_segments_np(words, gaps, counts, table, seg_bits=1024)
    np.testing.assert_array_equal(decoded, data)


def test_npref_single_symbol_stream():
    data = np.full(1000, 65, np.uint8)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    words, total_bits = npref.encode_bits(data, table)
    assert total_bits == 1000
    gaps, counts, _ = npref.segment_metadata(data, table, seg_bits=128)
    decoded = npref.decode_segments_np(words, gaps, counts, table, seg_bits=128)
    np.testing.assert_array_equal(decoded, data)


def test_compressed_size_beats_naive():
    data = generate_redundant(100_000, 0.9, seed=13)
    freqs = npref.histogram(data)
    table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
    _, total_bits = npref.encode_bits(data, table)
    assert total_bits < 8 * data.size * 0.6  # heavy redundancy compresses well
