"""Pallas kernels, compiled through Triton, for the ILS decode and pack.

One program runs a power-of-two block of one tile's 1024 streams
(grid = (tiles, 1024 / block)); the loop over all ``k/4`` bodies sits inside
the program, so nothing carries over between programs and they may run in
any order.  The loop bodies are the shared lane code of `ops/ils_xla.py`;
here they keep their state (the 128-bit register or accumulator, the
refill and emission pointers) in registers for the whole loop, where the
plain XLA version writes it back to device memory every body.

- ``ils_decode_triton``: each stream loads its own next word pair (a
  masked per-lane load bounded to the tile's rows) and stores each decoded
  u32 straight to its place in the output; the lane-decorrelation rotation
  is index arithmetic on that store address.
- ``ils_pack_certify_triton``: each stream packs its codewords, stores
  every finished word pair straight to its one slot of a worst-case-stride
  buffer, and records the decoder's refill-schedule envelope per ILS_WIN
  window (the container's certificate).  `ops/ils_xla.py::ils_compact`
  then gathers the tiles to their certified row offsets.

Small tables (encoder entries, decode limits, biases, symbols) are direct
gathers from global memory, which stay resident in L1/L2.  Each kernel is
checked against its plain XLA version (`ops/ils_xla.py`) in interpret mode
on the CPU and compiled on the GPU (``chip_smoke.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core.ils_ref import ILS_LANES, ils_n_win
from ..ils_xla import (
    IlsDecTabs,
    IlsEncTabs,
    U32,
    decode_lanes,
    pack_lanes,
    rot_word,
)

__all__ = ["ils_decode_triton", "ils_pack_certify_triton"]

#: streams per program and warps per program: one stream per thread,
#: measured best on the H100 for both kernels (PERF.md)
BLOCK = 128
WARPS = 4

_INDEX_LIMIT = 1 << 31  # element offsets are int32


def _streams(block):
    return pl.program_id(1) * block + jnp.arange(block, dtype=jnp.int32)


def _decode_kernel(rs_ref, lim_ref, bias_ref, sym_ref, pay_ref, out_ref, *,
                   kq, block, min_len, chain, rot):
    t = pl.program_id(0)
    s = _streams(block)
    start = rs_ref[t]
    w_tile = rs_ref[t + 1] - start
    base = start * ILS_LANES + s
    a = tuple(plgpu.load(pay_ref.at[base + j * ILS_LANES]) for j in range(4))

    def fetch(pptr, need):
        ok = need & (2 * pptr < w_tile)
        idx = base + 2 * pptr * ILS_LANES
        return (
            plgpu.load(pay_ref.at[idx], mask=ok, other=0),
            plgpu.load(pay_ref.at[idx + ILS_LANES], mask=ok, other=0),
        )

    def emit(mem, i, word):
        dst = rot_word(s, i) if rot else s
        plgpu.store(out_ref.at[(t * kq + i) * ILS_LANES + dst], word)
        return mem

    decode_lanes(
        a, (), kq=kq, lims=[lim_ref[l] for l, _ in chain],
        bias_at=lambda i: plgpu.load(bias_ref.at[i]),
        sym_at=lambda i: plgpu.load(sym_ref.at[i]),
        min_len=min_len, chain=chain, fetch=fetch, emit=emit,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "min_len", "chain", "rot", "block", "num_warps", "interpret"
    ),
)
def ils_decode_triton(payload, row_starts, dec: IlsDecTabs, *, k, min_len,
                      chain, rot=False, block=BLOCK, num_warps=WARPS,
                      interpret=False):
    """Same contract as `ops/ils_xla.py::ils_decode_xla`."""
    kq = k // 4
    n_tiles = row_starts.shape[0] - 1
    if max(payload.size, n_tiles * kq * ILS_LANES) >= _INDEX_LIMIT:
        raise ValueError("ILS section too large for int32 element offsets")
    kern = functools.partial(
        _decode_kernel, kq=kq, block=block, min_len=min_len, chain=chain,
        rot=rot,
    )
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n_tiles * kq * ILS_LANES,), U32),
        grid=(n_tiles, ILS_LANES // block),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ils_decode",
    )(row_starts, dec.lim, dec.bias, dec.symtab, payload.reshape(-1))
    return out.reshape(n_tiles * kq, ILS_LANES)


def _pack_kernel(snum_ref, enc_ref, data_ref, pay_ref, bits_ref, dn_ref,
                 dx_ref, *, kq, n_win, stride_rows, block, rot):
    t = pl.program_id(0)
    s = _streams(block)

    def word_at(i):
        src = rot_word(s, i) if rot else s
        return plgpu.load(data_ref.at[(t * kq + i) * ILS_LANES + src])

    def store_pair(mem, e, w0, w1, mask):
        idx = (t * stride_rows + 2 * e) * ILS_LANES + s
        plgpu.store(pay_ref.at[idx], w0, mask=mask)
        plgpu.store(pay_ref.at[idx + ILS_LANES], w1, mask=mask)
        return mem

    def store_env(mem, wi, gdn, gdx):
        idx = (t * n_win + wi) * ILS_LANES + s
        plgpu.store(dn_ref.at[idx], gdn)
        plgpu.store(dx_ref.at[idx], gdx)
        return mem

    _, bits = pack_lanes(
        (), shape=(block,), kq=kq, snum=snum_ref[0], word_at=word_at,
        entry_at=lambda i: plgpu.load(enc_ref.at[i]),
        store_pair=store_pair, store_env=store_env,
    )
    plgpu.store(bits_ref.at[t * ILS_LANES + s], bits)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "stride_rows", "rot", "block", "num_warps", "interpret"
    ),
)
def ils_pack_certify_triton(data, snum, enc: IlsEncTabs, *, k, stride_rows,
                            rot=False, block=BLOCK, num_warps=WARPS,
                            interpret=False):
    """Same contract as `ops/ils_xla.py::ils_pack_certify_xla`."""
    kq = k // 4
    n_tiles = data.shape[0] // kq
    n_win = ils_n_win(k)
    if n_tiles * stride_rows * ILS_LANES >= _INDEX_LIMIT:
        raise ValueError("ILS section too large for int32 element offsets")
    kern = functools.partial(
        _pack_kernel, kq=kq, n_win=n_win, stride_rows=stride_rows,
        block=block, rot=rot,
    )
    lanes = n_tiles * ILS_LANES
    pay, bits, dn, dx = pl.pallas_call(
        kern,
        out_shape=(
            jax.ShapeDtypeStruct((n_tiles * stride_rows * ILS_LANES,), U32),
            jax.ShapeDtypeStruct((lanes,), jnp.int32),
            jax.ShapeDtypeStruct((lanes * n_win,), jnp.int32),
            jax.ShapeDtypeStruct((lanes * n_win,), jnp.int32),
        ),
        grid=(n_tiles, ILS_LANES // block),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ils_pack_certify",
    )(jnp.reshape(snum, (1,)).astype(jnp.int32), enc.packed,
      data.reshape(-1))
    return (
        pay.reshape(-1, ILS_LANES),
        bits.reshape(n_tiles, ILS_LANES),
        dn.reshape(n_tiles, n_win, ILS_LANES),
        dx.reshape(n_tiles, n_win, ILS_LANES),
    )
