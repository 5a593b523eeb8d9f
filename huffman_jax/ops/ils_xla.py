"""Per-stream ILS decode and pack, written once over lanes of any shape.

The interleaved-stream layout (`core/ils_ref.py`) gives every stream a
fixed address: word ``j`` of stream ``s`` in tile ``t`` sits at payload row
``row_starts[t] + j``, column ``s``.  Decode and pack are therefore one
serial loop per stream over its ``k/4`` bodies of four symbols, with the
stream's own next word loaded (decode) or its finished word pair stored
(pack) at an address only it touches.  Each word has exactly one writer,
so no atomics are needed (the role of the reference's ``atomicOr``
boundary writes, `encoder.cu:317-347`).

The loop bodies here are pure ``jnp`` over lane arrays and take their
memory accesses as callbacks, so the same code is

- the plain XLA versions below (every lane of every tile at once, a
  ``fori_loop`` over bodies): the CPU backend and the GPU kernels'
  reference; and
- the bodies of the Pallas/Triton kernels (`ops/pallas/ils_kernels.py`),
  where one program runs a block of one tile's lanes and the state stays in
  registers for the whole loop.

State is u32 words and int32 counters only, so nothing depends on
``jax_enable_x64``; every variable shift stays below 32 (Triton's and
XLA's shifts by 32 or more are undefined) via the ``(x << 1) << (31 - s)``
guard.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.canonical import CodeTable
from ..core.ils_ref import ILS_LANES, ILS_ROT_LANE, ILS_ROT_SUB, ILS_WIN, ils_n_win

__all__ = [
    "IlsEncTabs",
    "IlsDecTabs",
    "ils_enc_tabs",
    "ils_dec_tabs",
    "rot_word",
    "decode_lanes",
    "pack_lanes",
    "ils_decode_xla",
    "ils_pack_certify_xla",
    "ils_compact",
]

U32 = jnp.uint32
_BIG = 1 << 30


class IlsEncTabs(NamedTuple):
    """Encoder table: ``(len << 20) | code`` per byte value."""

    packed: jnp.ndarray  # (256,) int32


class IlsDecTabs(NamedTuple):
    """Decoder tables for the canonical compare-chain symbol step."""

    lim: jnp.ndarray  # (32,) uint32 left-justified limits per level
    bias: jnp.ndarray  # (32,) int32 offsets[l] - first_code[l]
    symtab: jnp.ndarray  # (256,) int32 canonical rank -> symbol


def ils_enc_tabs(table: CodeTable) -> IlsEncTabs:
    packed = (table.lengths.astype(np.int32) << 20) | table.codes.astype(np.int32)
    return IlsEncTabs(jnp.asarray(packed))


def ils_dec_tabs(table: CodeTable) -> IlsDecTabs:
    lim = np.zeros(32, np.uint32)
    lim[: table.lim_left.shape[0]] = table.lim_left
    bias = np.zeros(32, np.int32)
    b = table.offsets.astype(np.int64) - table.first_code.astype(np.int64)
    bias[: b.shape[0]] = b
    symtab = np.zeros(256, np.int32)
    symtab[: table.num_symbols] = table.symtab
    return IlsDecTabs(jnp.asarray(lim), jnp.asarray(bias), jnp.asarray(symtab))


def rot_word(s, r, sign=-1):
    """Lane-decorrelation rotation (`core/ils_ref.py::ILS_ROT_SUB`) as index
    arithmetic: the word position of row ``r`` that stream ``s`` reads
    (``sign=-1``).  The same position is where decoded stream ``s``'s word
    goes back; ``sign=+1`` gives the inverse map, position -> stream."""
    sub = s >> 7
    lane = s & 127
    sub = (sub + sign * r * ILS_ROT_SUB) & 7  # & == floor mod (powers of 2)
    lane = (lane + sign * r * ILS_ROT_LANE) & 127
    return (sub << 7) | lane


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------
def _decode_symbol(a, valid, lims, bias_at, sym_at, min_len, chain):
    """One codeword off the top of the 128-bit register ``a`` (4 u32 words,
    MSB first).  The length comes from the canonical compare chain (one
    compare per distinct limit, `core/canonical.py::chain_spec`); it is
    never 0, so ``32 - ln`` is a defined shift."""
    a0, a1, a2, a3 = a
    ln = jnp.zeros_like(valid) + min_len
    for lim, (_, wt) in zip(lims, chain):
        ln = ln + jnp.where(a0 >= lim, wt, 0)
    lns = ln.astype(U32)
    rs = U32(32) - lns
    value = (a0 >> rs).astype(jnp.int32)
    sym = sym_at((bias_at(ln) + value) & 255)
    a = (
        (a0 << lns) | (a1 >> rs),
        (a1 << lns) | (a2 >> rs),
        (a2 << lns) | (a3 >> rs),
        a3 << lns,
    )
    return a, valid - ln, sym


def _insert_pair(a, valid, w0, w1):
    """OR the 64 bits (w0, w1) into ``a`` at bit offset ``valid`` (<= 64
    whenever the words are nonzero)."""
    r = valid.astype(U32) & U32(31)
    j0 = valid >> 5
    lsh = (U32(31) - r) & U32(31)
    hi0 = w0 >> r
    mid = ((w0 << U32(1)) << lsh) | (w1 >> r)
    lo1 = (w1 << U32(1)) << lsh
    return tuple(
        a[j]
        | jnp.where(j0 == j, hi0, U32(0))
        | jnp.where(j0 + 1 == j, mid, U32(0))
        | jnp.where(j0 + 2 == j, lo1, U32(0))
        for j in range(4)
    )


def decode_lanes(a, mem, *, kq, lims, bias_at, sym_at, min_len, chain, fetch,
                 emit):
    """Schedule-v2 decode of ``kq`` bodies for a set of lanes.

    ``a``: the register preloaded with each stream's words 0..3.
    ``fetch(pptr, need) -> (w0, w1)``: the stream's word pair ``pptr``
    (zeros where ``need`` is false or the pair lies past the tile's rows —
    those bits are never consumed).  ``emit(mem, i, word) -> mem``: body
    ``i``'s four symbols, which ARE the original little-endian u32.
    """
    valid = jnp.zeros(a[0].shape, jnp.int32) + 128
    pptr = jnp.zeros(a[0].shape, jnp.int32) + 2

    def body(i, st):
        a, valid, pptr, mem = st
        word = U32(0)
        for j in range(4):
            a, valid, sym = _decode_symbol(
                a, valid, lims, bias_at, sym_at, min_len, chain
            )
            word = word | (sym.astype(U32) << U32(8 * j))
        mem = emit(mem, i, word)
        need = valid <= 64
        w0, w1 = fetch(pptr, need)
        a = _insert_pair(a, valid, w0, w1)
        valid = valid + jnp.where(need, 64, 0)
        pptr = pptr + need.astype(jnp.int32)
        return a, valid, pptr, mem

    return jax.lax.fori_loop(0, kq, body, (a, valid, pptr, mem))[3]


# ----------------------------------------------------------------------
# Pack + certification
# ----------------------------------------------------------------------
def _acc_insert(a, used, entry):
    """OR one codeword (entry = (len << 20) | code) into the 128-bit
    MSB-first accumulator at bit offset ``used`` (<= 111: at most 63 bits
    carried plus three codewords of <= 16 bits)."""
    ln = entry >> 20
    code = (entry & 0xFFFF).astype(U32)
    c_left = (code << U32(1)) << (U32(31) - ln.astype(U32))
    r = used.astype(U32) & U32(31)
    j0 = used >> 5
    hi = c_left >> r
    lo = (c_left << U32(1)) << ((U32(31) - r) & U32(31))
    a = tuple(
        a[j]
        | jnp.where(j0 == j, hi, U32(0))
        | jnp.where(j0 + 1 == j, lo, U32(0))
        for j in range(4)
    )
    return a, used + ln


def pack_lanes(mem, *, shape, kq, snum, word_at, entry_at, store_pair,
               store_env):
    """Pack ``kq`` bodies per stream while simulating the decoder's refill
    schedule (the certificate stored in the container).

    ``shape``: the lane array shape.  ``word_at(i)``: each stream's data
    word of body ``i`` (4 symbols).
    ``store_pair(mem, e, w0, w1, mask) -> mem``: write the stream's word
    pair ``e`` where ``mask``.  ``store_env(mem, w, dmin, dmax) -> mem``:
    the refill deviation envelope of ILS_WIN-body window ``w``.
    Returns ``(mem, bits)`` with ``bits`` each stream's payload bit count.
    Emission and refill cadence follow `core/ils_ref.py` exactly.
    """
    z = jnp.zeros(shape, jnp.int32)

    def body(i, c):
        a, used, e_ptr, valid, pptr, gdn, gdx, mem = c
        w = word_at(i)
        l4 = z
        for j in range(4):
            entry = entry_at(((w >> U32(8 * j)) & U32(255)).astype(jnp.int32))
            a, used = _acc_insert(a, used, entry)
            l4 = l4 + (entry >> 20)
        mu = (i * snum) >> 16
        valid = valid - l4
        refill = valid <= 64
        dev = pptr - mu
        gdn = jnp.minimum(gdn, jnp.where(refill, dev, _BIG))
        gdx = jnp.maximum(gdx, jnp.where(refill, dev, -_BIG))
        pptr = pptr + refill.astype(jnp.int32)
        valid = valid + jnp.where(refill, 64, 0)
        emit = used >= 64
        mem = store_pair(mem, e_ptr, a[0], a[1], emit)
        a = (
            jnp.where(emit, a[2], a[0]),
            jnp.where(emit, a[3], a[1]),
            jnp.where(emit, U32(0), a[2]),
            jnp.where(emit, U32(0), a[3]),
        )
        used = used - jnp.where(emit, 64, 0)
        e_ptr = e_ptr + emit.astype(jnp.int32)
        return a, used, e_ptr, valid, pptr, gdn, gdx, mem

    def window(wi, c):
        a, used, e_ptr, valid, pptr, mem = c
        lo = wi * ILS_WIN
        hi = jnp.minimum(lo + ILS_WIN, kq)
        a, used, e_ptr, valid, pptr, gdn, gdx, mem = jax.lax.fori_loop(
            lo, hi, body,
            (a, used, e_ptr, valid, pptr, z + _BIG, z - _BIG, mem),
        )
        mem = store_env(mem, wi, gdn, gdx)
        return a, used, e_ptr, valid, pptr, mem

    a0 = (U32(0) + z.astype(U32),) * 4
    a, used, e_ptr, valid, pptr, mem = jax.lax.fori_loop(
        0, ils_n_win(4 * kq), window, (a0, z, z, z + 128, z + 2, mem)
    )
    # final flush of the zero-padded partial pair
    mem = store_pair(mem, e_ptr, a[0], a[1], used > 0)
    return mem, 64 * e_ptr + used


# ----------------------------------------------------------------------
# Plain XLA versions (all lanes of all tiles at once)
# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("k", "min_len", "chain", "rot"))
def ils_decode_xla(payload, row_starts, dec: IlsDecTabs, *, k, min_len, chain,
                   rot=False):
    """Decode every tile.

    payload: (rows, 1024) uint32 compact payload; row_starts: (n_tiles + 1,)
    int32.  Returns (n_tiles * k // 4, 1024) uint32 — the original data."""
    kq = k // 4
    n_tiles = row_starts.shape[0] - 1
    pay = payload.reshape(-1)
    s = jnp.arange(ILS_LANES, dtype=jnp.int32)[None]
    start = row_starts[:-1, None]
    w_tile = (row_starts[1:] - row_starts[:-1])[:, None]
    base = start * ILS_LANES + s
    a = tuple(pay[base + j * ILS_LANES] for j in range(4))

    def fetch(pptr, need):
        ok = need & (2 * pptr < w_tile)
        idx = jnp.where(ok, base + 2 * pptr * ILS_LANES, 0)
        return (jnp.where(ok, pay[idx], U32(0)),
                jnp.where(ok, pay[idx + ILS_LANES], U32(0)))

    def emit(out, i, word):
        if rot:
            word = jnp.take_along_axis(word, rot_word(s, i, +1), axis=1)
        return jax.lax.dynamic_update_index_in_dim(out, word, i, axis=1)

    out = decode_lanes(
        a, jnp.zeros((n_tiles, kq, ILS_LANES), U32), kq=kq,
        lims=[dec.lim[l] for l, _ in chain], bias_at=lambda i: dec.bias[i],
        sym_at=lambda i: dec.symtab[i], min_len=min_len, chain=chain,
        fetch=fetch, emit=emit,
    )
    return out.reshape(n_tiles * kq, ILS_LANES)


@functools.partial(jax.jit, static_argnames=("k", "stride_rows", "rot"))
def ils_pack_certify_xla(data, snum, enc: IlsEncTabs, *, k, stride_rows,
                         rot=False):
    """Pack every stream at worst-case tile stride and certify its schedule.

    data: (n_tiles * k // 4, 1024) uint32.  snum: () int32 schedule
    numerator.  Returns (payload_strided (n_tiles * stride_rows, 1024)
    uint32, bits (n_tiles, 1024) int32, dec_min, dec_max (n_tiles, n_win,
    1024) int32).  Strided rows past a stream's last word are unspecified
    (`ils_compact` masks them)."""
    kq = k // 4
    n_tiles = data.shape[0] // kq
    data3 = data.reshape(n_tiles, kq, ILS_LANES)
    s = jnp.arange(ILS_LANES, dtype=jnp.int32)[None]
    tile_base = (jnp.arange(n_tiles, dtype=jnp.int32) * stride_rows)[:, None]
    size = n_tiles * stride_rows * ILS_LANES

    def word_at(i):
        w = jax.lax.dynamic_index_in_dim(data3, i, axis=1, keepdims=False)
        if rot:
            w = jnp.take_along_axis(w, rot_word(s, i), axis=1)
        return w

    def store_pair(mem, e, w0, w1, mask):
        pay, dn, dx = mem
        idx = jnp.where(mask, (tile_base + 2 * e) * ILS_LANES + s, size)
        pay = pay.at[idx].set(w0, mode="drop")
        pay = pay.at[idx + ILS_LANES].set(w1, mode="drop")
        return pay, dn, dx

    def store_env(mem, wi, gdn, gdx):
        pay, dn, dx = mem
        dn = jax.lax.dynamic_update_index_in_dim(dn, gdn, wi, axis=1)
        dx = jax.lax.dynamic_update_index_in_dim(dx, gdx, wi, axis=1)
        return pay, dn, dx

    env = jnp.zeros((n_tiles, ils_n_win(k), ILS_LANES), jnp.int32)
    (pay, dn, dx), bits = pack_lanes(
        (jnp.zeros(size, U32), env, env), shape=(n_tiles, ILS_LANES), kq=kq,
        snum=snum, word_at=word_at,
        entry_at=lambda i: enc.packed[i], store_pair=store_pair,
        store_env=store_env,
    )
    return pay.reshape(-1, ILS_LANES), bits, dn, dx


@functools.partial(jax.jit, static_argnames=("stride_rows", "total_rows"))
def ils_compact(payload_strided, bits, row_starts, *, stride_rows, total_rows):
    """Gather each tile's rows from the strided pack output to its compact
    row offset (one row gather).  Words past each stream's own length are
    zeroed, so the strided buffer's unwritten rows never leak in.

    row_starts: (n_tiles + 1,) int32; ``total_rows >= row_starts[-1]`` (rows
    past the last tile come out zero).  Returns (total_rows, 1024) uint32."""
    n_tiles = bits.shape[0]
    r = jnp.arange(total_rows, dtype=jnp.int32)
    tile = jnp.minimum(
        jnp.searchsorted(row_starts[1:], r, side="right"), n_tiles - 1
    ).astype(jnp.int32)
    local = r - row_starts[tile]
    src = jnp.minimum(tile * stride_rows + local, payload_strided.shape[0] - 1)
    words = 2 * ((bits + 63) >> 6)  # even word count of each stream
    return jnp.where(
        local[:, None] < words[tile], payload_strided[src], U32(0)
    )
