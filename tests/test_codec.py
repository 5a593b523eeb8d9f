"""End-to-end codec + container tests."""

import numpy as np
import pytest

from huffman_jax.models import GapArrayCodec
from huffman_jax.io import write_container, read_container, container_size
from huffman_jax.utils import generate_redundant, generate_binomial


@pytest.mark.parametrize("redundancy", [0.1, 0.5, 0.9])
def test_codec_roundtrip(redundancy):
    data = generate_redundant(300_000, redundancy, seed=1)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 16)
    assert codec.roundtrip_check(data)


def test_codec_ragged_tail_and_multi_block():
    data = generate_redundant(200_001, 0.5, seed=2)  # ragged tail block
    codec = GapArrayCodec.fit(data, block_bytes=1 << 16)
    comp = codec.encode(data)
    assert comp.n_blocks == 4
    out = codec.decode(comp)
    np.testing.assert_array_equal(out, data)


def test_codec_empty_and_tiny():
    codec = GapArrayCodec.fit(np.array([7], np.uint8))
    comp = codec.encode(np.zeros(0, np.uint8))
    assert codec.decode(comp).size == 0
    data = np.array([7, 7, 7], np.uint8)
    codec = GapArrayCodec.fit(data)
    np.testing.assert_array_equal(codec.decode(codec.encode(data)), data)


def test_container_roundtrip():
    data = generate_binomial(150_000, seed=3)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 16)
    comp = codec.encode(data)
    blob = write_container(comp)
    assert len(blob) == container_size(comp)
    comp2 = read_container(blob)
    assert comp2.original_size == comp.original_size
    assert comp2.seg_bits == comp.seg_bits
    np.testing.assert_array_equal(comp2.table.lengths, comp.table.lengths)
    for a, b in zip(comp.block_words, comp2.block_words):
        np.testing.assert_array_equal(a, b)
    out = codec.decode(comp2)
    np.testing.assert_array_equal(out, data)


def test_htc1_container_detects_corruption():
    data = generate_redundant(60_000, 0.5, seed=31)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 16)
    blob = bytearray(write_container(codec.encode(data)))
    # flip a payload bit near the end
    bad = bytearray(blob)
    bad[-3] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        read_container(bytes(bad))
    # flip a bit in the first block's segment metadata
    bad = bytearray(blob)
    meta_off = len(blob) - 4 * sum(
        -(-tb // 32) for tb in codec.encode(data).block_total_bits
    ) - 2  # inside the last block's meta/payload region either way
    bad[meta_off] ^= 0x01
    with pytest.raises(ValueError, match="checksum"):
        read_container(bytes(bad))


def test_compression_beats_raw_and_overhead_is_small():
    data = generate_redundant(1_000_000, 0.9, seed=4)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 18)
    comp = codec.encode(data)
    blob = write_container(comp)
    payload_bits = sum(comp.block_total_bits)
    overhead = len(blob) - payload_bits / 8
    # metadata overhead below the reference's 3.125% gap-array overhead
    assert overhead / (payload_bits / 8) < 0.0313
    assert len(blob) < data.size


@pytest.mark.parametrize("method", ["lut", "canonical", "twolevel"])
def test_gap_codec_methods(method):
    from huffman_jax.models import GapArrayCodec
    from huffman_jax.utils import generate_redundant

    data = generate_redundant(300_000, 0.5, seed=30)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 17, method=method)
    comp = codec.encode(data)
    out = codec.decode(comp)
    assert np.array_equal(out, data)


def test_gap_codec_method_default_is_lut():
    # one XLA decode step everywhere; the backend does not pick it
    codec = GapArrayCodec.fit(np.arange(64, dtype=np.uint8))
    assert codec.method == "lut"


def test_gap_codec_device_resident_roundtrip():
    """encode_device -> decode_device keeps payload on device end to end;
    stage_host must equal the host encode exactly."""
    data = generate_redundant(1 << 18, 0.5, seed=33)
    codec = GapArrayCodec.fit(data, block_bytes=1 << 16)
    blocks = data.reshape(4, 1 << 16)
    dcomp = codec.encode_device(blocks)
    out = np.asarray(codec.decode_device(dcomp))
    np.testing.assert_array_equal(out.reshape(-1), data)

    # staged host form == the host encode path, block by block
    from huffman_jax.models.gap_codec import Compressed

    comp = Compressed(
        table=codec.table, seg_bits=codec.seg_bits, original_size=data.size,
        block_bytes=1 << 16, block_words=[], block_total_bits=[],
        block_gaps=[], block_counts=[],
    )
    codec.stage_host(dcomp, comp)
    ref = codec.encode(data)
    assert comp.block_total_bits == ref.block_total_bits
    for a, b in zip(comp.block_words, ref.block_words):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(comp.block_counts, ref.block_counts):
        np.testing.assert_array_equal(a, b)


def test_gap_codec_heterogeneous_blocks_match_single():
    """One vmapped group decode must equal per-block decodes bit for bit on
    heterogeneous content, where the per-block segment counts differ and
    zero-count padding segments sit at every block's tail."""
    import jax.numpy as jnp

    from huffman_jax.models import GapArrayCodec
    from huffman_jax.ops.decode import decode_block
    from huffman_jax.utils import generate_redundant

    bb = 1 << 15
    rng = np.random.default_rng(31)
    data = np.concatenate([
        generate_redundant(bb, 0.9, seed=1),          # short codes
        rng.integers(0, 256, bb).astype(np.uint8),    # incompressible
        generate_redundant(bb, 0.7, seed=3),          # mid entropy
        generate_redundant(bb, 0.3, seed=2),          # long codes
    ])
    codec = GapArrayCodec.fit(data, block_bytes=bb)
    comp = codec.encode(data)
    assert comp.n_blocks == 4
    assert len({c.size for c in comp.block_gaps}) > 1
    np.testing.assert_array_equal(codec.decode(comp), data)
    for j in range(comp.n_blocks):
        words = np.concatenate([comp.block_words[j], np.zeros(1, np.uint32)])
        counts = comp.block_counts[j]
        single = decode_block(
            jnp.asarray(words), jnp.asarray(comp.block_gaps[j].astype(np.int32)),
            jnp.asarray(counts), codec.dec, spec=codec.spec,
            seg_bits=codec.seg_bits, max_count=int(counts.max()),
            out_size=bb, method="lut",
        )
        np.testing.assert_array_equal(
            np.asarray(single), data[j * bb : (j + 1) * bb]
        )


def test_gap_codec_unaligned_block_bytes():
    """Block sizes that are not a multiple of 4096 B, with a ragged last
    block, still round-trip."""
    from huffman_jax.models import GapArrayCodec
    from huffman_jax.utils import generate_redundant

    rng = np.random.default_rng(32)
    data = np.concatenate([
        generate_redundant(100_000, 0.9, seed=7),
        rng.integers(0, 256, 100_000).astype(np.uint8),
        generate_redundant(30_000, 0.5, seed=8),
    ])
    codec = GapArrayCodec.fit(data, block_bytes=100_000)
    out = codec.decode(codec.encode(data))
    np.testing.assert_array_equal(out, data)


def test_gap_codec_degenerate_short_codes():
    # sub-2-bit mean code length: ~1000 codewords per 1024-bit segment
    from huffman_jax.models import GapArrayCodec

    data = np.zeros(40_000, np.uint8)
    data[::97] = 7
    codec = GapArrayCodec.fit(data)
    out = codec.decode(codec.encode(data))
    assert np.array_equal(out, data)
