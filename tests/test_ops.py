"""Device-op tests: JAX encode/decode vs the NumPy oracle (CPU backend)."""

import numpy as np
import pytest

import jax.numpy as jnp

from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.ops import (
    encode_block,
    decode_block,
    count_segments,
    histogram,
    device_enc_table,
    device_dec_table,
    dec_spec,
)
from huffman_jax.utils import generate_redundant, generate_binomial


def make_table(data, max_len=16):
    freqs = npref.histogram(data)
    return canonical_code_table(package_merge_lengths(freqs, max_len), max_len)


def cdiv(a, b):
    return -(-a // b)


def encode_args(data, table, seg_bits):
    lens = table.lengths[data].astype(np.int64)
    total_bits = int(lens.sum())
    max_words = cdiv(total_bits, 32)
    n_segs = max(cdiv(total_bits, seg_bits), 1)
    return max_words, n_segs, total_bits


@pytest.mark.parametrize("gen,seed", [("red0.5", 0), ("red0.9", 1), ("binom", 2)])
@pytest.mark.parametrize("seg_bits", [128, 1024])
def test_encode_matches_oracle(gen, seed, seg_bits):
    if gen == "binom":
        data = generate_binomial(20_000, seed=seed)
    else:
        data = generate_redundant(20_000, float(gen[3:]), seed=seed)
    table = make_table(data)
    max_words, n_segs, total_ref = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    words, total_bits, gaps, counts = encode_block(
        jnp.asarray(data), enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
    )
    ref_words, ref_total = npref.encode_bits(data, table)
    ref_gaps, ref_counts, _ = npref.segment_metadata(data, table, seg_bits)
    assert int(total_bits) == ref_total == total_ref
    np.testing.assert_array_equal(np.asarray(words)[: ref_words.size], ref_words)
    np.testing.assert_array_equal(np.asarray(gaps)[: len(ref_gaps)], ref_gaps)
    np.testing.assert_array_equal(np.asarray(counts)[: len(ref_counts)], ref_counts)


@pytest.mark.parametrize("gen,seed", [("red0.5", 10), ("red0.9", 11), ("binom", 12)])
@pytest.mark.parametrize("seg_bits", [128, 1024])
def test_encode_block_vmapped_matches_single(gen, seed, seg_bits):
    """The vmapped group encode (GapArrayCodec's device path) must be
    BIT-IDENTICAL to encoding each block alone (words, total_bits, gaps,
    counts)."""
    import jax

    n = 8192
    if gen == "binom":
        data = generate_binomial(3 * n, seed=seed)
    else:
        data = generate_redundant(3 * n, float(gen[3:]), seed=seed)
    table = make_table(data)
    max_words, n_segs, _ = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    kw = dict(enc=enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs)
    blocks = data.reshape(3, n)
    got = jax.vmap(lambda d: encode_block(d, **kw))(jnp.asarray(blocks))
    for j in range(3):
        ref = encode_block(jnp.asarray(blocks[j]), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g)[j], np.asarray(r))


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
@pytest.mark.parametrize("gen,seed", [("red0.5", 20), ("binom", 21)])
def test_count_segments_matches_npref(gen, seed, method):
    """The gap-only counting pass (pass 1 of the reference-format decode)
    must reproduce the encoder's per-segment counts at the reference's
    128-bit segments with every decode step."""
    from huffman_jax.ops import count_segments

    seg_bits = 128
    if gen == "binom":
        data = generate_binomial(40_000, seed=seed)
    else:
        data = generate_redundant(40_000, float(gen[3:]), seed=seed)
    table = make_table(data)
    words_np, total_bits = npref.encode_bits(data, table)
    gaps_np, counts_ref, _ = npref.segment_metadata(data, table, seg_bits)
    spec = dec_spec(table)
    got = count_segments(
        jnp.asarray(words_np),
        jnp.asarray(np.asarray(gaps_np, np.int32)),
        jnp.int32(total_bits),
        device_dec_table(table, two_level=(method == "twolevel")),
        spec=spec,
        seg_bits=seg_bits,
        max_count=seg_bits // spec.min_len + 1,
        method=method,
    )
    np.testing.assert_array_equal(np.asarray(got), counts_ref)


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
@pytest.mark.parametrize("gen,seed", [("red0.5", 3), ("red0.1", 4), ("binom", 5)])
def test_decode_roundtrip(method, gen, seed):
    seg_bits = 1024
    if gen == "binom":
        data = generate_binomial(20_000, seed=seed)
    else:
        data = generate_redundant(20_000, float(gen[3:]), seed=seed)
    table = make_table(data)
    max_words, n_segs, _ = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    words, total_bits, gaps, counts = encode_block(
        jnp.asarray(data), enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
    )
    dec = device_dec_table(table)
    spec = dec_spec(table)
    max_count = int(np.asarray(counts).max())
    out = decode_block(
        words,
        gaps,
        counts,
        dec,
        spec=spec,
        seg_bits=seg_bits,
        max_count=max_count,
        out_size=data.size,
        method=method,
    )
    np.testing.assert_array_equal(np.asarray(out), data)


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
def test_two_pass_gap_only_decode(method):
    """Reference-parity path: counts recovered on device from gaps alone."""
    seg_bits = 128
    data = generate_redundant(10_000, 0.5, seed=6)
    table = make_table(data)
    max_words, n_segs, _ = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    words, total_bits, gaps, counts = encode_block(
        jnp.asarray(data), enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
    )
    dec = device_dec_table(table)
    spec = dec_spec(table)
    counted = count_segments(
        words,
        gaps,
        total_bits,
        dec,
        spec=spec,
        seg_bits=seg_bits,
        max_count=seg_bits // spec.min_len + 1,
        method=method,
    )
    np.testing.assert_array_equal(np.asarray(counted), np.asarray(counts))
    out = decode_block(
        words,
        gaps,
        counted,
        dec,
        spec=spec,
        seg_bits=seg_bits,
        max_count=int(np.asarray(counted).max()),
        out_size=data.size,
        method=method,
    )
    np.testing.assert_array_equal(np.asarray(out), data)


def test_single_symbol_block():
    seg_bits = 128
    data = np.full(5000, 65, np.uint8)
    table = make_table(data)
    max_words, n_segs, _ = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    words, total_bits, gaps, counts = encode_block(
        jnp.asarray(data), enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
    )
    assert int(total_bits) == 5000
    out = decode_block(
        words,
        gaps,
        counts,
        dec=device_dec_table(table),
        spec=dec_spec(table),
        seg_bits=seg_bits,
        max_count=128,
        out_size=5000,
        method="canonical",
    )
    np.testing.assert_array_equal(np.asarray(out), data)


def test_histogram_matches_numpy():
    data = generate_binomial(50_000, seed=7)
    h = histogram(jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(h), npref.histogram(data).astype(np.int32))


def test_padded_capacity():
    """Encoding with extra capacity (padded max_words/n_segs) stays correct."""
    seg_bits = 1024
    data = generate_redundant(10_000, 0.5, seed=8)
    table = make_table(data)
    max_words, n_segs, _ = encode_args(data, table, seg_bits)
    enc = device_enc_table(table)
    words, total_bits, gaps, counts = encode_block(
        jnp.asarray(data),
        enc,
        seg_bits=seg_bits,
        max_words=max_words + 100,
        n_segs=n_segs + 7,
    )
    ref_words, ref_total = npref.encode_bits(data, table)
    assert int(total_bits) == ref_total
    np.testing.assert_array_equal(np.asarray(words)[: ref_words.size], ref_words)
    assert np.all(np.asarray(words)[ref_words.size :] == 0)
    assert np.all(np.asarray(counts)[n_segs:] == 0)
    out = decode_block(
        words,
        gaps,
        counts,
        dec=device_dec_table(table),
        spec=dec_spec(table),
        seg_bits=seg_bits,
        max_count=int(np.asarray(counts).max()),
        out_size=data.size,
    )
    np.testing.assert_array_equal(np.asarray(out), data)
