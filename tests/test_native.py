"""Native C++ host module vs NumPy implementations: bit-identical outputs.

Builds nothing itself — run `make -C native` first; tests skip when the
shared library is absent.
"""

import numpy as np
import pytest

from huffman_jax import native
from huffman_jax.core import canonical_code_table, npref
from huffman_jax.core.package_merge import package_merge_lengths
from huffman_jax.utils import generate_redundant

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)"
)


@pytest.mark.parametrize("r", [0.0, 0.5, 1.0])
def test_histogram_matches(r):
    data = generate_redundant(1_000_001, r, seed=20)
    assert np.array_equal(native.histogram(data), npref.histogram(data))


@pytest.mark.parametrize("r", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("max_len", [8, 12, 16])
def test_package_merge_matches(r, max_len):
    data = generate_redundant(300_000, r, seed=21)
    freqs = npref.histogram(data)
    if int(np.count_nonzero(freqs)) > (1 << max_len):
        pytest.skip("alphabet larger than 2^max_len")
    assert np.array_equal(
        native.package_merge_lengths(freqs, max_len),
        package_merge_lengths(freqs, max_len),
    )


def test_package_merge_edge_cases():
    freqs = np.zeros(256, np.int64)
    assert np.array_equal(native.package_merge_lengths(freqs, 16), np.zeros(256, np.uint8))
    freqs[7] = 100
    lens = native.package_merge_lengths(freqs, 16)
    assert lens[7] == 1 and lens.sum() == 1
    freqs[:] = 1  # uniform 256 symbols -> exactly 8 bits each
    assert np.all(native.package_merge_lengths(freqs, 16)[
        np.arange(256)] == 8)


def test_canonical_matches():
    data = generate_redundant(200_000, 0.4, seed=22)
    lengths = package_merge_lengths(npref.histogram(data), 16)
    table = canonical_code_table(lengths, 16)
    codes, symtab = native.canonical_pieces(lengths)
    assert np.array_equal(codes, table.codes)
    assert np.array_equal(symtab, table.symtab)


def test_canonical_rejects_kraft_violation():
    lengths = np.zeros(256, np.uint8)
    lengths[:3] = 1  # three 1-bit codes: impossible
    with pytest.raises(ValueError):
        native.canonical_pieces(lengths)


@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_encode_bits_matches(n):
    data = generate_redundant(max(n, 1), 0.5, seed=23)[:n]
    base = generate_redundant(100_000, 0.5, seed=23)
    lengths = package_merge_lengths(npref.histogram(base), 16)
    table = canonical_code_table(lengths, 16)
    if n == 0:
        data = np.zeros(0, np.uint8)
        w, t = native.encode_bits(data, table.codes, table.lengths)
        assert t == 0
        return
    # restrict to symbols present in the table
    data = base[:n]
    w_np, t_np = npref.encode_bits(data, table)
    w_nat, t_nat = native.encode_bits(data, table.codes, table.lengths)
    assert t_nat == t_np
    assert np.array_equal(w_nat, w_np)
