"""Device-side decode-table pytrees built from a host CodeTable.

Static configuration (LUT width, min/max code length) is kept OUT of the
pytrees — jit would trace pytree leaves — and carried in ``DecSpec``, which is
hashable and passed as a static argument.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.canonical import (
    CodeTable,
    build_flat_lut,
    build_two_level_table,
    chain_spec,
)

__all__ = [
    "DeviceEncTable",
    "DeviceDecTable",
    "DecSpec",
    "device_enc_table",
    "device_dec_table",
    "dec_spec",
]


class DeviceEncTable(NamedTuple):
    """Encoder-side table: per-symbol (code, length)."""

    codes: jnp.ndarray  # (256,) uint32 right-aligned canonical codes
    lengths: jnp.ndarray  # (256,) int32


class DeviceDecTable(NamedTuple):
    """Decoder-side tables (arrays only; static config lives in DecSpec).

    Carries three representations; kernels pick one:
    - flat LUT (``lut_sym``/``lut_len``, 2^lut_bits entries) — role of the
      reference's 2^11 LUT (`gpuhd/encoder/src/llhuffman_encoder.cc:240-262`);
    - canonical limit arithmetic (``lim_left``/``offsets``/``first_code``/
      ``symtab``) — code length via <=15 vector compares, symbol via one
      256-entry gather; no big table;
    - two-level L1/L2 (``l1_sym``/``l1_len``/``ptr_tab``/``l2_sym``/
      ``l2_len``) — the reference's `gpu_dec_l1_l2` table pair
      (`Huffman_coding_Gap_arrays/decoder/src/get_table.cpp:48-139`,
      consumed `decoder.cu:529-569`): short codes resolve in the 2^p L1,
      long codes chain through a per-prefix pointer into a compact L2.
    """

    lut_sym: jnp.ndarray  # (2^lut_bits,) int32
    lut_len: jnp.ndarray  # (2^lut_bits,) int32
    lim_left: jnp.ndarray  # (max_len+1,) uint32
    offsets: jnp.ndarray  # (max_len+1,) int32
    first_code: jnp.ndarray  # (max_len+1,) uint32
    symtab: jnp.ndarray  # (256,) int32 (zero-padded past num_symbols)
    l1_sym: jnp.ndarray  # (2^prefix_bits,) int32
    l1_len: jnp.ndarray  # (2^prefix_bits,) int32
    ptr_tab: jnp.ndarray  # (>=1,) uint32: (l2 width << 16) | l2 offset
    l2_sym: jnp.ndarray  # (>=1,) int32
    l2_len: jnp.ndarray  # (>=1,) int32


@dataclasses.dataclass(frozen=True)
class DecSpec:
    """Hashable static decode configuration."""

    lut_bits: int
    max_len: int  # deepest occupied level
    min_len: int  # shallowest occupied level
    prefix_bits: int = 0  # two-level L1 width (0: table lacks L1/L2 form)
    l1_boundary: int = 0  # first L1 index owned by long codes
    # grouped compare-chain spec (`core/canonical.py::chain_spec`): one
    # (level, weight) pair per distinct decode limit; None = dense chain.
    # Exact only for decodes starting at min_len (all current kernels do).
    chain: tuple | None = None


def device_enc_table(table: CodeTable) -> DeviceEncTable:
    return DeviceEncTable(
        codes=jnp.asarray(table.codes, jnp.uint32),
        lengths=jnp.asarray(table.lengths.astype(np.int32)),
    )


def _two_level_prefix(table: CodeTable) -> int:
    # the reference uses a fixed 2^10/2^11 L1 (`get_table.cpp:48`); cap at
    # the deepest level so an all-short table has no L2 at all
    return min(10, max(table.max_len_present, 1))


def _two_level_boundary(table: CodeTable, p: int) -> int:
    """First p-bit L1 index owned by long codes — the cheap scalar form of
    ``build_two_level_table(...).boundary_code`` (equivalence pinned by
    tests), so ``dec_spec`` need not build the full L2 arrays."""
    syms = table.symtab
    ls = table.lengths[syms].astype(np.int64)
    cs = table.codes[syms].astype(np.int64)
    long = ls > p
    if not np.any(long):
        return 1 << p
    return int((cs[long] >> (ls[long] - p)).min())


def dec_spec(table: CodeTable, lut_bits: int | None = None) -> DecSpec:
    b = int(lut_bits if lut_bits is not None else max(table.max_len_present, 1))
    p = _two_level_prefix(table)
    return DecSpec(
        lut_bits=b,
        max_len=max(table.max_len_present, 1),
        min_len=max(table.min_len, 1),
        prefix_bits=p,
        l1_boundary=_two_level_boundary(table, p),
        chain=chain_spec(table),
    )


def device_dec_table(
    table: CodeTable,
    lut_bits: int | None = None,
    *,
    two_level: bool = True,
) -> DeviceDecTable:
    """Build the device decode tables.

    ``two_level=False`` skips the L1/L2 construction (a host loop plus five
    device uploads) and stores 1-element pads instead — pass it on paths that
    never select the "twolevel" decode method; `ops/decode.py` raises if the
    twolevel step meets a padded table.
    """
    b = int(lut_bits if lut_bits is not None else max(table.max_len_present, 1))
    lut_sym, lut_len = build_flat_lut(table, b)
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab

    def pad1(a, dtype):  # gathers need >= 1 element
        return jnp.asarray(a.astype(dtype) if a.size else np.zeros(1, dtype))

    if two_level:
        two = build_two_level_table(table, _two_level_prefix(table))
        l1_sym = jnp.asarray(two.l1_sym.astype(np.int32))
        l1_len = jnp.asarray(two.l1_len.astype(np.int32))
        ptr_tab = pad1(two.ptr_table, np.uint32)
        l2_sym = pad1(two.l2_sym, np.int32)
        l2_len = pad1(two.l2_len, np.int32)
    else:
        l1_sym = l1_len = jnp.zeros(1, jnp.int32)
        ptr_tab = jnp.zeros(1, jnp.uint32)
        l2_sym = l2_len = jnp.zeros(1, jnp.int32)

    return DeviceDecTable(
        lut_sym=jnp.asarray(lut_sym.astype(np.int32)),
        lut_len=jnp.asarray(lut_len.astype(np.int32)),
        lim_left=jnp.asarray(table.lim_left, jnp.uint32),
        offsets=jnp.asarray(table.offsets, jnp.int32),
        first_code=jnp.asarray(table.first_code, jnp.uint32),
        symtab=jnp.asarray(symtab),
        l1_sym=l1_sym,
        l1_len=l1_len,
        ptr_tab=ptr_tab,
        l2_sym=l2_sym,
        l2_len=l2_len,
    )
