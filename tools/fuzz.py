"""Differential fuzzing soak: random inputs x params, kernels vs oracle.

Every iteration draws a random data distribution, size, k and max_len, then
checks three independent implementations against each other:

- the NumPy ILS oracle round-trips (encode_np -> decode_np);
- the device path (the Triton kernels on the GPU, their plain XLA versions
  on the CPU) produces the SAME payload and schedule parameters as the
  oracle and decodes bit-exactly;
- the container survives serialization.

Run:  python tools/fuzz.py [--iters N] [--seed S]   (on the default backend)
Exits non-zero on the first divergence, printing a reproducer line.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def gen_case(rng):
    kind = rng.choice(
        ["redundant", "binomial", "two", "blocky", "ascending", "single",
         "sparse", "zipf"]
    )
    n_tiles = int(rng.integers(1, 4))
    k = int(rng.choice([8, 12, 16, 24]))
    extra = int(rng.integers(0, 3000)) if rng.random() < 0.5 else 0
    n = n_tiles * k * 1024 + extra
    if kind == "redundant":
        r = float(rng.random())
        from huffman_jax.utils import generate_redundant

        data = generate_redundant(n, r, seed=int(rng.integers(1 << 30)))
    elif kind == "binomial":
        data = rng.binomial(255, rng.uniform(0.05, 0.95), n).astype(np.uint8)
    elif kind == "two":
        a, b = rng.integers(0, 256, 2)
        data = rng.choice([a, b], n, p=[0.99, 0.01]).astype(np.uint8)
    elif kind == "blocky":
        parts = []
        left = n
        while left > 0:
            m = min(int(rng.integers(100, 20000)), left)
            sub = rng.choice(["z", "u", "c"])
            if sub == "z":
                parts.append(np.zeros(m, np.uint8))
            elif sub == "u":
                parts.append(rng.integers(0, 256, m).astype(np.uint8))
            else:
                parts.append(np.full(m, rng.integers(0, 256), np.uint8))
            left -= m
        data = np.concatenate(parts)
    elif kind == "ascending":
        data = (np.arange(n) % int(rng.integers(2, 257))).astype(np.uint8)
    elif kind == "single":
        data = np.full(n, rng.integers(0, 256), np.uint8)
    elif kind == "sparse":
        data = np.zeros(n, np.uint8)
        idx = rng.integers(0, n, max(n // 50, 1))
        data[idx] = rng.integers(0, 256, idx.size)
    else:  # zipf
        data = np.clip(rng.zipf(rng.uniform(1.2, 2.5), n), 0, 255).astype(
            np.uint8
        )
    max_len = int(rng.choice([8, 9, 12, 16]))
    return kind, data, k, max_len


def one_case(i, rng):
    from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
    from huffman_jax.core.ils_ref import ILS_LANES, ils_decode_np, ils_encode_np
    from huffman_jax.io import read_ils_container, write_ils_container
    from huffman_jax.models import IlsCodec
    from huffman_jax.ops.ils import ils_encode_device
    from huffman_jax.ops.ils_xla import ils_enc_tabs

    kind, data, k, max_len = gen_case(rng)
    rot = [False, True, "auto"][int(rng.integers(3))]
    freqs = npref.histogram(data)
    if int(np.count_nonzero(freqs)) > (1 << max_len):
        max_len = 16

    codec = IlsCodec.fit(data, k=k, max_len=max_len, rotate=rot)
    comp = codec.encode(data)
    blob = write_ils_container(comp)
    out = codec.decode(read_ils_container(blob))
    assert np.array_equal(out, data), "codec roundtrip mismatch"

    # oracle differential on the aligned prefix
    tile_bytes = k * ILS_LANES
    n_full = (data.size // tile_bytes) * tile_bytes
    if n_full:
        chunk = data[:n_full]
        table = codec.table
        sec = ils_encode_device(
            chunk, table, ils_enc_tabs(table), k=k,
            avg_bits=float(table.lengths.astype(np.int64)[chunk].mean()),
            rot=rot,
        )
        # rot="auto" resolves per content; the oracle must mirror the
        # device path's certified decision to compare payloads bit-for-bit
        payload_np, params_np = ils_encode_np(
            chunk, table, k, rot=sec.params.rot
        )
        assert np.array_equal(
            ils_decode_np(payload_np, params_np, table), chunk
        ), "oracle roundtrip mismatch"
        assert np.array_equal(sec.payload, payload_np), "payload != oracle"
        assert np.array_equal(sec.params.w_tiles, params_np.w_tiles)
        assert np.array_equal(sec.params.boffs, params_np.boffs)
        assert sec.params.w_cap == params_np.w_cap
    return kind, data.size, k, max_len


def secondary_case(i, rng):
    """Secondary-path differential: gap-array codec (random decode method),
    self-sync decode of a raw stream, and the reference Yamamoto container,
    on a small random slice."""
    from huffman_jax.core import canonical_code_table, npref, package_merge_lengths
    from huffman_jax.io.yamamoto import decode_yamamoto, write_yamamoto
    from huffman_jax.models import GapArrayCodec
    from huffman_jax.models.selfsync import selfsync_decode_device

    kind, data, _, max_len = gen_case(rng)
    n = int(rng.integers(1, 80_000))
    data = data[:n]
    freqs = npref.histogram(data)
    if int(np.count_nonzero(freqs)) > (1 << max_len):
        max_len = 16

    which = rng.choice(["gap", "gapdev", "selfsync", "yamamoto"])
    if which == "gap":
        method = str(rng.choice(["lut", "canonical", "twolevel"]))
        codec = GapArrayCodec.fit(
            data, max_len=max_len, block_bytes=int(rng.choice(
                [1 << 14, 1 << 16, 1 << 24])), method=method,
        )
        out = codec.decode(codec.encode(data))
        assert np.array_equal(out, data), f"gap[{method}] roundtrip mismatch"
        which = f"gap[{method}]"
    elif which == "gapdev":
        # device-resident pipeline: the device encode feeding the device
        # decode — the counterpart of the host-staged `gap` case above
        import jax.numpy as jnp

        bb = 1 << int(rng.integers(12, 16))
        g = max(n // bb, 1)
        d = data[: g * bb]
        if d.size < g * bb:
            d = np.pad(d, (0, g * bb - d.size))
        codec = GapArrayCodec.fit(d, max_len=max_len, block_bytes=bb)
        dcomp = codec.encode_device(jnp.asarray(d.reshape(g, bb)))
        out = np.asarray(codec.decode_device(dcomp)).reshape(-1)
        assert np.array_equal(out, d), "gapdev device roundtrip mismatch"
    elif which == "selfsync":
        table = canonical_code_table(
            package_merge_lengths(freqs, max_len), max_len
        )
        words, total_bits = npref.encode_bits(data, table)
        out = selfsync_decode_device(words, total_bits, table)
        assert np.array_equal(np.asarray(out), data), "selfsync mismatch"
    else:
        table = canonical_code_table(
            package_merge_lengths(freqs, max_len), max_len
        )
        out = decode_yamamoto(write_yamamoto(data, table))
        assert np.array_equal(np.asarray(out), data), "yamamoto mismatch"
    return which, data.size, 0, max_len


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--secondary-every", type=int, default=4, metavar="N",
                    help="run a secondary-path case every N iterations "
                         "(0 disables)")
    args = ap.parse_args()

    from huffman_jax.backend import platform, setup_compile_cache

    setup_compile_cache()
    print(f"fuzz on {platform()}", flush=True)

    rng = np.random.default_rng(args.seed)
    for i in range(args.iters):
        sec = args.secondary_every and i % args.secondary_every == (
            args.secondary_every - 1
        )
        case = secondary_case if sec else one_case
        try:
            kind, n, k, max_len = case(i, rng)
            print(f"[{i:3d}] ok  {kind:14s} n={n:8d} k={k:3d} L={max_len}",
                  flush=True)
        except Exception as e:
            print(f"[{i:3d}] FAIL seed={args.seed} iter={i}: {e}", flush=True)
            raise
    print(f"fuzz: {args.iters} cases PASS")


if __name__ == "__main__":
    main()
