"""Binary interop vs the COMPILED reference sequential codec.

The strongest correctness evidence the project can produce: blobs cross the
process boundary to/from the reference's own compiled `sequential.cpp`
(`/root/reference`, built at test time behind `native/ref_seq_driver.cpp` —
no reference code is copied).  Both directions are exercised, mirroring the
reference's own PASS/FAIL main (`sequential.cpp:236-277`):

- (a) reference encode -> our `decode_seq` (foreign greedy-tree codes,
  generally NOT canonical: `sequential.cpp:123-144` ties break on
  unordered_map iteration order);
- (b) our `write_seq` -> reference decode (canonical codes, same format,
  `sequential.cpp:163-204`).
"""

import numpy as np
import pytest

from huffman_jax.core import canonical_code_table, npref, package_merge_lengths
from huffman_jax.io import refbin
from huffman_jax.io.seqfmt import decode_seq, read_seq_header, write_seq
from huffman_jax.utils import generate_redundant

pytestmark = pytest.mark.skipif(
    not refbin.ref_available(),
    reason="reference sequential.cpp not present on this host",
)


def _fit(data, max_len=16):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), max_len), max_len
    )


def _roundtrip_both_ways(data):
    blob = refbin.ref_encode(data)
    out = decode_seq(blob, device=False)
    assert np.array_equal(out, data), "ours failed to decode reference blob"

    blob2 = write_seq(data, _fit(data))
    out2 = refbin.ref_decode(blob2)
    assert np.array_equal(out2, data), "reference failed to decode our blob"
    return blob, blob2


@pytest.mark.parametrize("r", [0.1, 0.5, 0.9])
def test_interop_small(r):
    data = generate_redundant(200_000, r, seed=int(r * 10))
    _roundtrip_both_ways(data)


def test_interop_100mb():
    """BASELINE.json config 1: >= 100 MB generate.cpp-semantics data,
    round-trip vs the compiled sequential reference, both directions."""
    from huffman_jax import native

    if not native.available():
        pytest.skip("native module not built (host walk too slow at 100 MB)")
    data = generate_redundant(100 * 1024 * 1024, 0.5, seed=0)
    blob, blob2 = _roundtrip_both_ways(data)
    # our canonical container is never larger than the reference's blob
    # (optimal package-merge lengths vs greedy tree, same header format)
    assert len(blob2) <= len(blob)


def test_interop_skewed_long_codes():
    # Zipf-ish skew drives the greedy tree deep (max_len well past 16):
    # exercises the non-canonical host walk fallback path.
    rng = np.random.default_rng(5)
    vals = np.minimum(rng.geometric(0.08, size=400_000) - 1, 255)
    data = vals.astype(np.uint8)
    blob = refbin.ref_encode(data)
    code, _, _ = read_seq_header(blob)
    out = decode_seq(blob, device=False)
    assert np.array_equal(out, data)


def test_interop_tiny_and_single_symbol():
    one = np.full(1000, 7, np.uint8)
    blob = refbin.ref_encode(one)
    assert np.array_equal(decode_seq(blob, device=False), one)
    blob2 = write_seq(one, _fit(one))
    assert np.array_equal(refbin.ref_decode(blob2), one)
