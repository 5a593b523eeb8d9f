"""Sharded block-parallel codec: shard_map over a device mesh.

Multi-device orchestration (SURVEY §2.7): the input stream is
split into independent fixed-size blocks at *encode* time (always
codeword-aligned by construction — the fix the reference's broken multi-GPU
prescan demo was groping toward, `gpuhd-multigpu/multigpu_demo_prescan.cc:276-319`),
the block axis is sharded over the mesh's ``data`` axis, the code table is
replicated, the global histogram is a per-shard histogram + ``psum``, and the
ordered gather of decoded blocks is just the output sharding of the jitted
step (no host staging).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .mesh import DATA_AXIS, Mesh, P
from ..ops import DecSpec
from ..ops.decode import decode_block
from ..ops.encode import encode_block, histogram

__all__ = [
    "sharded_histogram",
    "make_sharded_encode",
    "make_sharded_decode",
    "make_sharded_roundtrip",
]


def sharded_histogram(mesh: Mesh, blocks: jnp.ndarray) -> jnp.ndarray:
    """Global (256,) histogram of a (n_blocks, B) array sharded over blocks.

    Per-shard scatter-add histogram + psum over the mesh — the collective
    analog of the reference's per-GPU histograms merged on host
    (`huffman_parallel_gpu.cpp:200-272`).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(DATA_AXIS, None),
        out_specs=P(),
    )
    def hist(local):
        h = histogram(local.reshape(-1))
        return jax.lax.psum(h, DATA_AXIS)

    return jax.jit(hist)(blocks)


def make_sharded_encode(
    mesh: Mesh,
    *,
    seg_bits: int,
    max_words: int,
    n_segs: int,
):
    """Jitted sharded encode: (n_blocks, B) uint8 -> per-block padded streams.

    Returns fn(blocks, enc) -> (words (n_blocks, max_words+1) u32,
    total_bits (n_blocks,), gaps (n_blocks, n_segs), counts (n_blocks, n_segs)),
    all sharded over blocks.
    """

    def per_block(d, enc):
        return encode_block(
            d, enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS, None), P(DATA_AXIS, None)),
    )
    def enc_fn(blocks, enc):
        return jax.vmap(lambda d: per_block(d, enc))(blocks)

    return jax.jit(enc_fn)


def make_sharded_decode(
    mesh: Mesh,
    *,
    spec: DecSpec,
    seg_bits: int,
    max_count: int,
    out_size: int,
    method: str = "lut",
):
    """Jitted sharded decode: per-block streams -> (n_blocks, out_size) uint8.

    The output sharding (blocks over ``data``) IS the ordered gather: callers
    reshape to the flat stream; XLA inserts the all-gather only if the
    consumer needs it unsharded.
    """

    def per_block(w, g, c, dec):
        return decode_block(
            w,
            g,
            c,
            dec,
            spec=spec,
            seg_bits=seg_bits,
            max_count=max_count,
            out_size=out_size,
            method=method,
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None), P()),
        out_specs=P(DATA_AXIS, None),
    )
    def dec_fn(words, gaps, counts, dec):
        return jax.vmap(lambda w, g, c: per_block(w, g, c, dec))(
            words, gaps, counts
        )

    return jax.jit(dec_fn)


def make_sharded_roundtrip(
    mesh: Mesh,
    *,
    spec: DecSpec,
    seg_bits: int,
    max_words: int,
    n_segs: int,
    max_count: int,
    block_bytes: int,
    method: str = "lut",
):
    """The full device step (encode -> decode -> verify) over the mesh.

    This is the framework's "training step" analog: one jitted program,
    sharded over all chips, that exercises encode, metadata extraction,
    decode, ordered recombination and bit-exact verification.
    Returns fn(blocks, enc, dec) -> (decoded (n_blocks, B), ok ()).
    """

    def per_block(d, enc, dec):
        words, _, gaps, counts = encode_block(
            d, enc, seg_bits=seg_bits, max_words=max_words, n_segs=n_segs
        )
        return decode_block(
            words,
            gaps,
            counts,
            dec,
            spec=spec,
            seg_bits=seg_bits,
            max_count=max_count,
            out_size=block_bytes,
            method=method,
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(), P()),
        out_specs=(P(DATA_AXIS, None), P()),
    )
    def step(blocks, enc, dec):
        out = jax.vmap(lambda d: per_block(d, enc, dec))(blocks)
        ok_local = jnp.all(out == blocks)
        ok = jax.lax.pmin(ok_local.astype(jnp.int32), DATA_AXIS)
        return out, ok

    return jax.jit(step)
