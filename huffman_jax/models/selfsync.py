"""Self-synchronizing decoder — decode raw Huffman streams with NO metadata.

Capability parity with the reference's CUHD decoder (`gpuhd/`): given only a
canonical code table and the packed bit stream (no gap array, no counts —
e.g. a stream produced by a foreign encoder such as `sequential.cpp`),
recover all codeword boundaries and decode data-parallel.

Pipeline (contrast `gpuhd/src/cuhd_gpu_decoder.cu:422-523`), plain XLA:

1. **Transition pass** (`sync_transitions`): every subsequence decoded from
   all 16 possible entry offsets, lengths only, in the style of
   `ops/decode.py::count_segments` — replaces CUHD's speculative phase 1/2
   re-decode + host convergence loop with an exact, single-dispatch
   computation.
2. **Composition scan**: each subsequence is a [16] -> [16] transition
   FUNCTION; ``jax.lax.associative_scan`` composes them
   (``(a then b)(s) = b[a(s)]``, expanded gather-free as 16 selects) in
   O(log n) vector steps, yielding every subsequence's true entry state —
   the role of CUHD's thrust::exclusive_scan (`:497-505`) and sync
   iteration combined, exact in int32 at any stream length.
3. **Decode pass**: the gap+count decode (`ops/decode.py::decode_block`)
   consumes (entry, count) per subsequence exactly as if an encoder-side
   gap array existed.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.canonical import CodeTable, chain_spec
from ..ops.bitops import extract_window32
from ..ops.decode import decode_block
from ..ops.tables import dec_spec, device_dec_table

__all__ = [
    "selfsync_decode_words",
    "selfsync_decode_device",
    "selfsync_decode_bytes",
    "is_canonical",
    "sync_transitions",
]

_SEG_BITS = 1024
SYNC_STATES = 16  # entry states: a codeword crosses an edge by < max_len bits


def _cdiv(a, b):
    return -(-a // b)


def _compose_scan(exits: jnp.ndarray) -> jnp.ndarray:
    """Inclusive scan of transition composition over exit states ONLY.

    exits: (n, 16) int.  Returns entry (n,) int32: the true entry state of
    each subsequence.  A subsequence is a FUNCTION [16] -> [16] (entry
    state -> exit state); the scan composes functions:
    ``(a then b)(s) = b[a(s)]``, with the 16-entry application expanded as
    16 where-selects — gather-free, exact in int32, and (n, 16)-sized all
    the way up.  (A formulation as 16x16 one-hot matrix products is exact
    too, but its (n, 16, 16) fp32 prefix arrays cost 16x the memory.)
    Symbol counts are deliberately NOT carried through the scan: prefix
    counts accumulate to the stream total, which exceeds fp32's 2^24 above ~16 MB decoded; they
    are derived afterwards by an exact integer ``take_along_axis`` +
    ``cumsum`` over the selected per-subsequence counts (the role of
    thrust::exclusive_scan in the reference, `cuhd_gpu_decoder.cu:497-505`,
    which is likewise exact).
    """
    f = exits.astype(jnp.int32)  # (n, 16): f[i, s] = exit state of subseq i
    n = exits.shape[0]
    # pad to a power of two with IDENTITY transitions: associative_scan's
    # odd/even recursion at ragged lengths emits a slice zoo that compiles
    # far slower than the padded scan; identity tail entries never affect
    # prefixes
    np2 = 1 << max(n - 1, 1).bit_length()
    if np2 != n:
        ident = jnp.broadcast_to(
            jnp.arange(SYNC_STATES, dtype=jnp.int32)[None],
            (np2 - n, SYNC_STATES),
        )
        f = jnp.concatenate([f, ident], axis=0)

    def combine(a, b):
        acc = jnp.zeros_like(a)
        for k in range(SYNC_STATES):
            acc = acc + jnp.where(a == k, b[:, k : k + 1], 0)
        return acc

    pg = jax.lax.associative_scan(combine, f, axis=0)
    exit_state = pg[:, 0]  # composed transition applied to entry state 0
    return jnp.concatenate([jnp.zeros(1, jnp.int32), exit_state[: n - 1]])


def _compose_scan_packed(exits: jnp.ndarray) -> jnp.ndarray:
    """`_compose_scan` with the 16 four-bit states NIBBLE-PACKED into
    (n, 2) int32 — identical results (pinned by tests).

    The scan is HBM-traffic bound, not op bound: each associative_scan
    round reads/writes full (n, 16) int32 prefix arrays, ~128 bytes per
    subsequence per round x ~20 rounds at 128 MB streams.  Packing cuts
    the per-element footprint 8x; the combine's op count rises (16 x 16
    select-accumulate on nibbles), but those fuse into the same pass."""
    f = exits.astype(jnp.int32)
    n = exits.shape[0]
    np2 = 1 << max(n - 1, 1).bit_length()
    if np2 != n:
        ident = jnp.broadcast_to(
            jnp.arange(SYNC_STATES, dtype=jnp.int32)[None],
            (np2 - n, SYNC_STATES),
        )
        f = jnp.concatenate([f, ident], axis=0)

    halves = [
        sum((f[:, 8 * h + j] << (4 * j)) for j in range(8)) for h in (0, 1)
    ]
    packed = jnp.stack(halves, axis=1)  # (np2, 2) int32

    def combine(a, b):
        bk = [(b[:, k >> 3] >> (4 * (k & 7))) & 15 for k in range(16)]
        out = []
        for h in (0, 1):
            acc = jnp.zeros_like(a[:, 0])
            for j in range(8):
                a_s = (a[:, h] >> (4 * j)) & 15
                r = jnp.zeros_like(a_s)
                for k in range(16):
                    r = r + jnp.where(a_s == k, bk[k], 0)
                acc = acc | (r << (4 * j))
            out.append(acc)
        return jnp.stack(out, axis=1)

    pg = jax.lax.associative_scan(combine, packed, axis=0)
    exit_state = pg[:, 0] & 15  # composed transition applied to state 0
    return jnp.concatenate([jnp.zeros(1, jnp.int32), exit_state[: n - 1]])


def selfsync_decode_words(
    words: np.ndarray, total_bits: int, table: CodeTable
) -> np.ndarray:
    """Decode a raw MSB-first u32 stream given only its canonical table."""
    return np.asarray(selfsync_decode_device(words, total_bits, table))


@functools.partial(
    jax.jit, static_argnames=("seg_bits", "n_subseq", "min_len", "chain")
)
def sync_transitions(words, total_bits, lim, *, seg_bits, n_subseq, min_len,
                     chain):
    """Per-(subsequence, entry state) transitions of a raw bit stream.

    Every subsequence ``i`` covers bits ``[i*seg_bits, (i+1)*seg_bits)``;
    from each entry offset ``e`` in 0..15 it counts the codewords that START
    inside it (lengths only, canonical compare chain) and records the exit
    offset into the next subsequence.

    Args:
      words: (W,) uint32 MSB-first payload, zero-padded past
        ``(n_subseq + 1) * seg_bits`` bits.
      total_bits: () int32 exact stream length in bits.
      lim: (32,) uint32 canonical left-justified limits.

    Returns (exits, counts), each (n_subseq, 16) int32.
    """
    i = jnp.arange(n_subseq, dtype=jnp.int32)[:, None]
    pos0 = i * seg_bits + jnp.arange(SYNC_STATES, dtype=jnp.int32)[None]
    end = jnp.minimum((i + 1) * seg_bits, total_bits)
    steps = -(-seg_bits // max(min_len, 1)) + 1

    def cond(c):
        j, pos, _ = c
        return (j < steps) & jnp.any(pos < end)

    def body(c):
        j, pos, cnt = c
        window = extract_window32(words, pos)
        ln = jnp.zeros_like(pos) + min_len
        for l, wt in chain:
            ln = ln + jnp.where(window >= lim[l], wt, 0)
        active = pos < end
        return (
            j + 1,
            pos + jnp.where(active, ln, 0),
            cnt + active.astype(jnp.int32),
        )

    _, pos, cnt = jax.lax.while_loop(
        cond, body, (jnp.int32(0), pos0, jnp.zeros_like(pos0))
    )
    exits = jnp.clip(pos - (i + 1) * seg_bits, 0, SYNC_STATES - 1)
    return exits, cnt


@functools.partial(
    jax.jit, static_argnames=("seg_bits", "n_subseq", "min_len", "chain")
)
def _selfsync_meta(words, total_bits, lim, *, seg_bits, n_subseq, min_len,
                   chain):
    """Transitions + composition scan + per-subsequence (entry, count), in
    one dispatch; only two scalars (total and max count) go to the host."""
    exits, counts16 = sync_transitions(
        words, total_bits, lim, seg_bits=seg_bits, n_subseq=n_subseq,
        min_len=min_len, chain=chain,
    )
    entry = _compose_scan_packed(exits)
    counts = jnp.take_along_axis(counts16, entry[:, None], axis=1)[:, 0]
    head = jnp.stack([jnp.sum(counts), jnp.max(counts)]).astype(jnp.int32)
    return entry, counts, head


def selfsync_decode_device(
    words: np.ndarray, total_bits: int, table: CodeTable
):
    """`selfsync_decode_words` keeping the decoded bytes ON DEVICE: two
    dispatches (metadata, then the gap+count decode) with two scalars
    synced to the host in between."""
    if total_bits == 0:
        return np.zeros(0, np.uint8)
    max_len = max(table.max_len_present, 1)
    if max_len > SYNC_STATES:
        raise ValueError("self-sync decode requires max codeword length <= 16")
    min_len = max(table.min_len, 1)
    # POWER-OF-TWO subsequence count: subsequences past total_bits count
    # zero codewords, so rounding up is free, and it keeps the composition
    # scan at a power-of-two length
    n_subseq = _cdiv(total_bits, _SEG_BITS)
    n_subseq = 1 << max(n_subseq - 1, 1).bit_length()
    lim = np.zeros(32, np.uint32)
    lim[: table.lim_left.shape[0]] = table.lim_left
    need = (n_subseq + 1) * (_SEG_BITS // 32) + 2
    words = np.asarray(words, np.uint32)[:need]
    words_j = jnp.asarray(np.pad(words, (0, need - words.size)))
    entry, counts, head = _selfsync_meta(
        words_j, jnp.int32(total_bits), jnp.asarray(lim), seg_bits=_SEG_BITS,
        n_subseq=n_subseq, min_len=min_len, chain=chain_spec(table),
    )
    total_syms, max_count = (int(x) for x in np.asarray(head))
    return decode_block(
        words_j, entry, counts, device_dec_table(table, two_level=False),
        spec=dec_spec(table), seg_bits=_SEG_BITS,
        max_count=_cdiv(max(max_count, 1), 8) * 8, out_size=total_syms,
        method="lut",
    )


def is_canonical(lengths: np.ndarray, codes: np.ndarray) -> bool:
    """True iff (codes, lengths) is a canonical code: codes of each length
    are consecutive and each level continues (prev + 1) << diff."""
    syms = np.nonzero(np.asarray(lengths) > 0)[0]
    if syms.size == 0:
        return True
    ls = np.asarray(lengths)[syms].astype(np.int64)
    cs = np.asarray(codes)[syms].astype(np.int64)
    order = np.lexsort((cs, ls))
    ls, cs = ls[order], cs[order]
    code = 0
    for i in range(syms.size):
        if i:
            code = (code + 1) << (ls[i] - ls[i - 1])
        if cs[i] != code:
            return False
    return True


def selfsync_decode_bytes(payload: np.ndarray, total_bits: int, code) -> np.ndarray:
    """Decode an MSB-first byte stream via self-sync (canonical codes), or
    fall back to the host LUT walk for non-canonical prefix codes."""
    from ..io.seqfmt import PrefixCode

    assert isinstance(code, PrefixCode)
    if not is_canonical(code.lengths, code.codes) or code.max_len > SYNC_STATES:
        # foreign greedy-tree codes (or codes past the 16-state transition
        # table): host oracle walk, native-speed (sequential.cpp:88-94)
        from ..io.seqfmt import host_lut_decode

        return host_lut_decode(payload, total_bits, code)

    # canonical: rebuild a CodeTable in canonical (len, code) order
    from ..io.yamamoto import table_from_length_sequence

    syms = np.nonzero(code.lengths > 0)[0]
    ls = code.lengths[syms].astype(np.int64)
    cs = code.codes[syms].astype(np.int64)
    order = np.lexsort((cs, ls))
    table = table_from_length_sequence(syms[order].astype(np.uint8), ls[order])
    n_bytes = -(-total_bits // 8)
    padded = np.zeros(_cdiv(n_bytes, 4) * 4 + 8, np.uint8)
    padded[:n_bytes] = payload[:n_bytes]
    words = np.frombuffer(padded.tobytes(), ">u4").astype(np.uint32)
    return selfsync_decode_words(words, total_bits, table)
