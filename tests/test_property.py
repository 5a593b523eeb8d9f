"""Property-style randomized round-trip grid across codecs and formats.

The reference's only test was a self-verifying round-trip on one fixture
(SURVEY §4).  This grid sweeps entropy, size alignment, alphabet shape and
code-length limits across every codec and container in the framework, all
against the same invariant: decode(encode(x)) == x, bit for bit.
"""

import numpy as np
import pytest

from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.core.ils_ref import ILS_LANES
from huffman_jax.io import read_ils_container, write_ils_container
from huffman_jax.io.seqfmt import decode_seq, write_seq
from huffman_jax.io.yamamoto import decode_yamamoto, write_yamamoto
from huffman_jax.models import GapArrayCodec, IlsCodec
from huffman_jax.utils import generate_binomial, generate_redundant


def _cases():
    rng = np.random.default_rng(1234)
    cases = []
    for i, r in enumerate([0.05, 0.35, 0.65, 0.97]):
        n = int(rng.integers(3000, 90000))
        cases.append((f"redundant-{r}-{n}", generate_redundant(n, r, seed=i)))
    cases.append(("binomial", generate_binomial(40000, seed=5)))
    cases.append(("two-symbols", rng.choice([7, 200], 30000).astype(np.uint8)))
    cases.append(
        ("blocky", np.concatenate([
            np.zeros(20000, np.uint8),
            rng.integers(0, 256, 20000).astype(np.uint8),
            np.full(20000, 42, np.uint8),
        ]))
    )
    cases.append(("ascending", (np.arange(50000) % 256).astype(np.uint8)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name,data", CASES, ids=[c[0] for c in CASES])
def test_ils_roundtrip_property(name, data):
    codec = IlsCodec.fit(data, k=8)
    blob = write_ils_container(codec.encode(data))
    out = codec.decode(read_ils_container(blob))
    assert np.array_equal(out, data)


@pytest.mark.parametrize("name,data", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_gap_roundtrip_property(name, data):
    codec = GapArrayCodec.fit(data, seg_bits=256, block_bytes=1 << 15)
    assert codec.roundtrip_check(data)


@pytest.mark.parametrize("name,data", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_reference_formats_property(name, data):
    table = canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16
    )
    assert np.array_equal(decode_yamamoto(write_yamamoto(data, table)), data)
    assert np.array_equal(decode_seq(write_seq(data, table)), data)


@pytest.mark.parametrize("max_len", [9, 12, 16])
def test_ils_respects_max_len(max_len):
    data = generate_binomial(30000, seed=7)
    codec = IlsCodec.fit(data, max_len=max_len, k=8)
    assert int(codec.table.lengths.max()) <= max_len
    assert codec.roundtrip_check(data)
