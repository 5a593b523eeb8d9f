"""Sharded codec tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.ops import device_enc_table, device_dec_table, dec_spec
from huffman_jax.parallel import (
    data_mesh,
    sharded_histogram,
    make_sharded_encode,
    make_sharded_decode,
    make_sharded_roundtrip,
)
from huffman_jax.utils import generate_redundant


def cdiv(a, b):
    return -(-a // b)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return data_mesh(8)


def test_sharded_histogram(mesh):
    data = generate_redundant(8 * 4096, 0.5, seed=0)
    blocks = jnp.asarray(data.reshape(16, -1))
    h = sharded_histogram(mesh, blocks)
    np.testing.assert_array_equal(
        np.asarray(h), npref.histogram(data).astype(np.int32)
    )


def test_sharded_roundtrip_step(mesh):
    seg_bits = 128
    block_bytes = 2048
    n_blocks = 16
    data = generate_redundant(n_blocks * block_bytes, 0.5, seed=1)
    table = canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16
    )
    spec = dec_spec(table)
    max_words = cdiv(block_bytes * 16, 32)
    n_segs = cdiv(max_words * 32, seg_bits)
    step = make_sharded_roundtrip(
        mesh,
        spec=spec,
        seg_bits=seg_bits,
        max_words=max_words,
        n_segs=n_segs,
        max_count=seg_bits // spec.min_len + 1,
        block_bytes=block_bytes,
        method="canonical",
    )
    blocks = jnp.asarray(data.reshape(n_blocks, block_bytes))
    out, ok = step(blocks, device_enc_table(table), device_dec_table(table))
    assert int(ok) == 1
    np.testing.assert_array_equal(np.asarray(out).reshape(-1), data)


def test_sharded_encode_matches_single_device(mesh):
    seg_bits = 1024
    block_bytes = 4096
    n_blocks = 8
    data = generate_redundant(n_blocks * block_bytes, 0.3, seed=2)
    table = canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16
    )
    enc = device_enc_table(table)
    max_words = cdiv(block_bytes * 16, 32)
    n_segs = cdiv(max_words * 32, seg_bits)
    enc_fn = make_sharded_encode(
        mesh, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
    )
    blocks = jnp.asarray(data.reshape(n_blocks, block_bytes))
    words, total_bits, gaps, counts = enc_fn(blocks, enc)
    # compare each block against the NumPy oracle
    for i in range(n_blocks):
        ref_words, ref_total = npref.encode_bits(data.reshape(n_blocks, -1)[i], table)
        assert int(total_bits[i]) == ref_total
        np.testing.assert_array_equal(
            np.asarray(words[i])[: ref_words.size], ref_words
        )
    # and decode back, sharded
    dec_fn = make_sharded_decode(
        mesh,
        spec=dec_spec(table),
        seg_bits=seg_bits,
        max_count=int(np.asarray(counts).max()),
        out_size=block_bytes,
    )
    out = dec_fn(words, gaps, counts, device_dec_table(table))
    np.testing.assert_array_equal(np.asarray(out).reshape(-1), data)
