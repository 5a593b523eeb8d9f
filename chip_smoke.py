#!/usr/bin/env python3
"""Smoke test of the codec on the GPU, through the entry points a user calls.

    python chip_smoke.py               # one card: every default phase
    python chip_smoke.py --devices 4   # four cards: the sharded ILS path only

Default phases, one process, one card:

1. device facts (JAX's view and ``nvidia-smi``'s name and power limit);
2. ``IlsCodec`` round trips: 1 GB of ``generate_redundant`` r=0.5, and
   256 MB of seeded heterogeneous blocks (zeros, random, text, lane-periodic)
   under ``rotate="auto"``; the compiled Triton kernels must be what runs;
3. kernels against the plain XLA references at real width, tolerance zero:
   Triton decode against the input and the XLA decode of the same container,
   Triton pack against the XLA pack (rotation off and on), and a 4 MB slice's
   container against the NumPy oracle ``ils_encode_np``;
4. the CLI ``encode``/``decode`` of a 256 MB file, whole and section-streamed
   (``--stream --section-bytes 67108864``), compared byte for byte;
5. HTC1 at 256 MB, Yamamoto at 64 MB and self-sync at 64 MB, bit-exact.

With ``--devices 4``: 4 GB (1 GB per card) through
``ils_sharded_certified_encode`` + ``make_ils_sharded_decode``, compared
with the input and with a one-card decode of the same container.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failed phase, a missing GPU or a missing library exits non-zero without
that line.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

GB = 1 << 30
MB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Runs named phases, logs their time, and remembers failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 - every failure is reported
            traceback.print_exc()
            self.failed.append(name)
            log(f"[FAIL] {name} ({time.perf_counter() - t0:.1f} s)")
            return None
        log(f"[ok]   {name} ({time.perf_counter() - t0:.1f} s)")
        return out


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def heterogeneous(size: int, seed: int) -> np.ndarray:
    """1 MB blocks of zeros, random bytes, word text and 4 KB-periodic
    content, in a seeded random order."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(512)]
    text = np.frombuffer(
        b" ".join(words[i] for i in rng.integers(0, 512, 400_000)), np.uint8
    )
    period = rng.integers(0, 256, 4096).astype(np.uint8)
    period.reshape(8, 512)[::2] = 0
    out = np.empty(size, np.uint8)
    for off in range(0, size, MB):
        n = min(MB, size - off)
        kind = rng.integers(0, 4)
        if kind == 0:
            out[off : off + n] = 0
        elif kind == 1:
            out[off : off + n] = rng.integers(0, 256, n, dtype=np.uint8)
        elif kind == 2:
            s = int(rng.integers(0, text.size - n))
            out[off : off + n] = text[s : s + n]
        else:
            out[off : off + n] = np.resize(period, n)
    return out


# ----------------------------------------------------------------------
# one-card phases
# ----------------------------------------------------------------------
def kernels_compiled(data_dev, codec):
    """The ILS dispatchers must lower to Triton kernels (a compiled custom
    call), never to the Pallas interpreter's loop."""
    import jax

    from huffman_jax import backend
    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.ops.ils import ils_decode, ils_pack_certify

    check(backend.use_kernels(), "backend did not choose the GPU kernels")
    rows = data_dev[: 4 * 1024]
    starts = jax.numpy.asarray(np.array([0, 4 * 1024], np.int32))
    texts = [
        jax.jit(lambda d: ils_pack_certify(
            d, jax.numpy.int32(1 << 16), codec.enc, k=4096, stride_rows=2048,
        )).lower(data_dev[:1024]).as_text(),
        jax.jit(lambda p: ils_decode(
            p, starts, codec.dec, k=4096, min_len=codec.table.min_len,
            chain=chain_spec(codec.table),
        )).lower(rows).as_text(),
    ]
    for text in texts:
        check("triton" in text, "ILS kernel did not lower to Triton")


def ils_roundtrip(data, rotate="auto"):
    from huffman_jax.models import IlsCodec

    codec = IlsCodec.fit(data, rotate=rotate)
    comp = codec.encode(data)
    out = codec.decode(comp)
    check(np.array_equal(out, data), "IlsCodec round trip differs")
    ratio = comp.compressed_bytes / data.size
    log(f"       {data.size >> 20} MB k={codec.k} sections={len(comp.sections)}"
        f" rot={[s.params.rot for s in comp.sections]} ratio={ratio:.4f}")
    return codec, comp


def kernels_vs_reference(data, codec, comp):
    """Triton against plain XLA at real width, and a slice against the
    NumPy oracle; tolerance zero (integer codec)."""
    import jax.numpy as jnp

    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.core.ils_ref import ils_encode_np
    from huffman_jax.ops.ils import (
        as_u32_rows,
        ils_encode_device,
        stride_rows_for,
    )
    from huffman_jax.ops.ils_xla import (
        ils_compact,
        ils_decode_xla,
        ils_pack_certify_xla,
    )
    from huffman_jax.ops.pallas.ils_kernels import (
        ils_decode_triton,
        ils_pack_certify_triton,
    )

    table = codec.table
    (sec,) = comp.sections
    p = sec.params
    rows = jnp.asarray(sec.payload)
    starts = jnp.asarray(p.row_starts)
    data_dev = jnp.asarray(as_u32_rows(data))
    kw = dict(k=p.k, min_len=table.min_len, chain=chain_spec(table), rot=p.rot)
    out_t = ils_decode_triton(rows, starts, codec.dec, **kw)
    check(bool(jnp.array_equal(out_t, data_dev)), "Triton decode != input")
    out_x = ils_decode_xla(rows, starts, codec.dec, **kw)
    check(bool(jnp.array_equal(out_t, out_x)), "Triton decode != XLA decode")
    del out_t, out_x

    stride = stride_rows_for(p.k, table.max_len_present)
    snum = jnp.int32(p.snum)
    for rot in (False, True):
        n = data_dev.shape[0] if not rot else data_dev.shape[0] // 4
        d = data_dev[:n]
        t = ils_pack_certify_triton(d, snum, codec.enc, k=p.k,
                                    stride_rows=stride, rot=rot)
        x = ils_pack_certify_xla(d, snum, codec.enc, k=p.k,
                                 stride_rows=stride, rot=rot)
        for name, a, b in zip(("bits", "dec_min", "dec_max"), t[1:], x[1:]):
            check(bool(jnp.array_equal(a, b)), f"Triton pack {name} != XLA "
                  f"(rot={rot})")
        bits = np.asarray(t[1])
        w_tiles = np.maximum(2 * (-(-bits.max(axis=1) // 64)), 4)
        rs = jnp.asarray(np.concatenate([[0], np.cumsum(w_tiles)]).astype(np.int32))
        total = int(w_tiles.sum())
        ct = ils_compact(t[0], t[1], rs, stride_rows=stride, total_rows=total)
        cx = ils_compact(x[0], x[1], rs, stride_rows=stride, total_rows=total)
        check(bool(jnp.array_equal(ct, cx)), f"Triton payload != XLA (rot={rot})")
        del t, x, ct, cx

    piece = data[: p.k * 1024]  # one tile: 4 MB at k=4096
    for rot in (False, True):
        got = ils_encode_device(piece, table, codec.enc, k=p.k,
                                avg_bits=codec._avg_bits(piece), rot=rot)
        ref_payload, ref = ils_encode_np(piece, table, p.k, rot=rot)
        gp = got.params
        check(np.array_equal(got.payload, ref_payload), "payload != oracle")
        check((gp.snum, gp.w_band, gp.w_cap, gp.rot)
              == (ref.snum, ref.w_band, ref.w_cap, ref.rot), "params != oracle")
        check(np.array_equal(gp.boffs, ref.boffs), "boffs != oracle")
        check(np.array_equal(gp.w_tiles, ref.w_tiles), "w_tiles != oracle")


def cli_files(data, workdir):
    from huffman_jax.cli import main as cli

    src = os.path.join(workdir, "data.bin")
    data.tofile(src)
    for extra in ([], ["--stream", "--section-bytes", str(64 * MB)]):
        enc = os.path.join(workdir, "data.ils")
        out = os.path.join(workdir, "out.bin")
        cli(["encode", src, "-o", enc] + extra)
        cli(["decode", enc, "-o", out] + (["--stream"] if extra else []))
        check(filecmp.cmp(src, out, shallow=False),
              f"CLI round trip differs ({' '.join(extra) or 'whole'})")
        os.remove(enc)
        os.remove(out)


def secondary(data):
    from huffman_jax.core import npref
    from huffman_jax.io.yamamoto import decode_yamamoto, write_yamamoto
    from huffman_jax.models import GapArrayCodec
    from huffman_jax.models.selfsync import selfsync_decode_words

    htc = data[: 256 * MB]
    gap = GapArrayCodec.fit(htc)
    check(np.array_equal(gap.decode(gap.encode(htc)), htc), "HTC1 differs")
    small = data[: 64 * MB]
    check(np.array_equal(decode_yamamoto(write_yamamoto(small, gap.table)),
                         small), "Yamamoto differs")
    words, total_bits = npref.encode_bits(small, gap.table)
    check(np.array_equal(selfsync_decode_words(words, total_bits, gap.table),
                         small), "self-sync differs")


def one_card(phases):
    import jax.numpy as jnp

    from huffman_jax.utils import generate_redundant

    data = generate_redundant(GB, 0.5, seed=0)
    res = phases.run("ILS round trip, 1 GB r=0.5", ils_roundtrip, data)
    if res is not None:
        codec, comp = res
        phases.run("kernels lower to Triton", kernels_compiled,
                   jnp.asarray(data[: 4 * 4096 * 1024].view("<u4")
                               .reshape(-1, 1024)), codec)
        phases.run("kernels vs references, 1 GB", kernels_vs_reference,
                   data, codec, comp)
        del comp
    het = heterogeneous(256 * MB, seed=1)
    phases.run("ILS round trip, 256 MB heterogeneous, rotate=auto",
               ils_roundtrip, het)
    with tempfile.TemporaryDirectory() as workdir:
        phases.run("CLI encode/decode, 256 MB, whole and streamed", cli_files,
                   het, workdir)
    phases.run("HTC1 256 MB, Yamamoto 64 MB, self-sync 64 MB", secondary, data)


# ----------------------------------------------------------------------
# four-card phase
# ----------------------------------------------------------------------
def device_redundant(n_dev: int, per_dev: int, r: float, seed: int):
    """generate_redundant's distribution (A-D with probability r, else
    uniform bytes), drawn on each device from a seeded key."""
    import jax
    import jax.numpy as jnp

    def draw(key):
        k1, k2, k3 = jax.random.split(key, 3)
        n = per_dev // 4
        low = jax.random.bernoulli(k1, r, (n, 4))
        a = jax.random.randint(k2, (n, 4), 65, 69, jnp.uint32)
        b = jax.random.randint(k3, (n, 4), 0, 256, jnp.uint32)
        byte = jnp.where(low, a, b)
        return (byte << jnp.arange(0, 32, 8, dtype=jnp.uint32)).sum(
            axis=1, dtype=jnp.uint32).reshape(-1, 1024)

    keys = jax.random.split(jax.random.key(seed), n_dev)
    return [jax.jit(draw)(jax.device_put(k, d))
            for d, k in zip(jax.devices(), keys)]


def four_cards(phases, n_dev):
    import jax
    import jax.numpy as jnp

    from huffman_jax.core.canonical import canonical_code_table, chain_spec
    from huffman_jax.core.package_merge import package_merge_lengths
    from huffman_jax.ops.ils import ils_decode, pick_k
    from huffman_jax.ops.ils_xla import ils_dec_tabs, ils_enc_tabs
    from huffman_jax.parallel import (
        data_mesh,
        ils_sharded_certified_encode,
        make_ils_sharded_decode,
    )
    from huffman_jax.parallel.mesh import DATA_AXIS, NamedSharding, P

    def run():
        mesh = data_mesh(n_dev)
        shards = device_redundant(n_dev, GB, 0.5, seed=4)
        sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
        data_dev = jax.make_array_from_single_device_arrays(
            (n_dev,) + shards[0].shape, sharding, [s[None] for s in shards]
        )
        # the table from a 64 MB sample of every card (+1 keeps every byte
        # value codable); certification measures the real schedule anyway
        freqs = np.ones(256, np.int64)
        for s in shards:
            w = s[: 16 * 1024]
            for sh in (0, 8, 16, 24):
                freqs += np.asarray(jnp.bincount(
                    ((w >> sh) & 255).astype(jnp.int32).reshape(-1),
                    length=256))
        table = canonical_code_table(package_merge_lengths(freqs, 16), 16)
        avg = float((freqs * table.lengths).sum() / freqs.sum())
        k = pick_k(avg)
        tpd = GB // (k * 1024)
        enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
        sec = ils_sharded_certified_encode(
            mesh, data_dev, enc, k=k, max_len=table.max_len_present,
            avg_bits=avg, tiles_per_device=tpd,
        )
        out = make_ils_sharded_decode(
            mesh, k=k, min_len=table.min_len, chain=chain_spec(table),
        )(sec.payload_dev, sec.starts_dev, dec)
        check(bool(jnp.array_equal(out, data_dev)), "sharded decode != input")
        del out
        # one-card decode of the same container
        pays = np.asarray(sec.payload_dev)
        starts = np.asarray(sec.starts_dev)
        payload = np.concatenate(
            [pays[d, : starts[d, -1]] for d in range(n_dev)]
        )
        del pays
        check(payload.shape[0] == sec.params.total_rows, "payload rows")
        dev0 = jax.devices()[0]
        one = ils_decode(
            jax.device_put(payload, dev0),
            jax.device_put(sec.params.row_starts, dev0), dec, k=k,
            min_len=table.min_len, chain=chain_spec(table),
        )
        for d, s in enumerate(shards):
            check(bool(jnp.array_equal(
                one[d * s.shape[0] : (d + 1) * s.shape[0]],
                jax.device_put(s, dev0),
            )), f"one-card decode != input on shard {d}")
        log(f"       {n_dev} x 1 GB k={k} w_band={sec.params.w_band} "
            f"w_cap={sec.params.w_cap} rows={sec.params.total_rows}")

    phases.run(f"sharded ILS path, {n_dev} x 1 GB", run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded ILS path on four cards")
    args = ap.parse_args(argv)
    try:
        import jax

        from huffman_jax import backend
    except ImportError as e:
        print(f"chip_smoke: cannot import the library: {e}", file=sys.stderr)
        return 2
    backend.setup_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    if len(devs) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(f"devices: {len(devs)} x {devs[0].device_kind} ({devs[0].platform})")
    log(card_line())
    phases = Phases()
    t0 = time.perf_counter()
    if args.devices == 4:
        four_cards(phases, 4)
    else:
        one_card(phases)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if phases.failed:
        print(f"chip_smoke: failed phases: {phases.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
