"""ILS codec throughput on one GPU: the Triton kernels against the plain XLA
versions, plus the secondary codecs.

    python bench.py [--size BYTES] [--redundancy R [R ...]] [--reps N]
                    [--sweep] [--secondary] [--cpu]

Prints the card's name and power limit, then one JSON object per
measurement.  Every time is the median of ``--reps`` runs after one
warm-up run, host clock around work that ends in ``jax.block_until_ready``,
with inputs and outputs resident on the device.  Throughput is
uncompressed bytes per second (the reference's convention).  Refuses to run
on a platform other than ``gpu`` unless ``--cpu`` is given (CPU numbers are
for rehearsal only and are never device metrics).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np


def card() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_seconds(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def bench_ils(size: int, r: float, reps: int, device: dict,
              interpret: bool, sweep: bool) -> None:
    import jax.numpy as jnp

    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.core.ils_ref import ils_schedule_numer
    from huffman_jax.models import IlsCodec
    from huffman_jax.ops.ils import (
        as_u32_rows,
        ils_encode_to_device,
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
    from huffman_jax.utils import generate_redundant

    data = generate_redundant(size, r, seed=0)
    codec = IlsCodec.fit(data)
    k, table = codec.k, codec.table
    n = size - size % (k * 1024)
    data_dev = jnp.asarray(as_u32_rows(data[:n]))
    avg = codec._avg_bits(data[:n])
    snum = jnp.int32(ils_schedule_numer(avg))
    stride = stride_rows_for(k, table.max_len_present)
    rows, starts, p = ils_encode_to_device(
        data_dev, codec.enc, k=k, avg_bits=avg,
        max_len=table.max_len_present, rot="auto",
    )
    dkw = dict(k=k, min_len=table.min_len, chain=chain_spec(table), rot=p.rot)
    pkw = dict(k=k, stride_rows=stride, rot=p.rot)
    pack = {
        "triton": lambda: ils_pack_certify_triton(
            data_dev, snum, codec.enc, interpret=interpret, **pkw),
        "xla": lambda: ils_pack_certify_xla(data_dev, snum, codec.enc, **pkw),
    }
    decode = {
        "triton": lambda: ils_decode_triton(
            rows, starts, codec.dec, interpret=interpret, **dkw),
        "xla": lambda: ils_decode_xla(rows, starts, codec.dec, **dkw),
    }
    # bit-exactness of every variant before timing any
    ok = all(bool(jnp.array_equal(f(), data_dev)) for f in decode.values())
    for f in pack.values():
        pay_s, bits, _, _ = f()  # the Triton output is used last, below
        ok &= bool(jnp.array_equal(ils_compact(
            pay_s, bits, starts, stride_rows=stride, total_rows=p.total_rows
        ), rows))
    base = dict(size=n, redundancy=r, k=k, rot=p.rot, w_band=p.w_band,
                ratio=round(p.total_rows * 4096 / n, 4), exact=ok, **device)
    tune = []
    if sweep:  # Triton launch shapes: (streams per program, warps)
        for blk, nw in ((64, 2), (256, 8), (256, 4)):
            cfg = dict(block=blk, num_warps=nw)
            tune += [
                (f"pack_triton_b{blk}_w{nw}", functools.partial(
                    ils_pack_certify_triton, data_dev, snum, codec.enc,
                    **cfg, **pkw)),
                (f"decode_triton_b{blk}_w{nw}", functools.partial(
                    ils_decode_triton, rows, starts, codec.dec, **cfg, **dkw)),
            ]
    for name, fn in tune + [(f"pack_{v}", f) for v, f in pack.items()] + [
        (f"decode_{v}", f) for v, f in decode.items()
    ] + [
        ("encode_end_to_end", lambda: ils_encode_to_device(
            data_dev, codec.enc, k=k, avg_bits=avg,
            max_len=table.max_len_present, rot="auto")[0]),
        ("compact", lambda: ils_compact(
            pay_s, bits, starts, stride_rows=stride, total_rows=p.total_rows)),
    ]:
        s = median_seconds(fn, reps)
        emit(dict(base, op=name, seconds=s, gb_per_s=n / s / 1e9))


def bench_secondary(size: int, r: float, reps: int, device: dict) -> None:
    """HTC1 encode and decode, Yamamoto and self-sync decode (their
    host-side container parsing and copies included)."""
    import jax.numpy as jnp

    from huffman_jax.core import npref
    from huffman_jax.io.yamamoto import decode_yamamoto, write_yamamoto
    from huffman_jax.models import GapArrayCodec
    from huffman_jax.models.selfsync import selfsync_decode_device
    from huffman_jax.utils import generate_redundant

    data = generate_redundant(size, r, seed=0)
    gap = GapArrayCodec.fit(data)
    bb = min(gap.block_bytes, size)
    blocks = jnp.asarray(data[: size - size % bb].reshape(-1, bb))
    dcomp = gap.encode_device(blocks)
    out = gap.decode_device(dcomp)
    rows = [
        ("htc1_encode", blocks.size, lambda: gap.encode_device(blocks).words,
         True),
        ("htc1_decode", blocks.size, lambda: gap.decode_device(dcomp),
         bool(jnp.array_equal(out, blocks))),
    ]
    blob = write_yamamoto(data, gap.table)
    rows.append(("yamamoto_decode", size, lambda: decode_yamamoto(blob),
                 bool(np.array_equal(decode_yamamoto(blob), data))))
    words, total_bits = npref.encode_bits(data, gap.table)
    rows.append(("selfsync_decode", size,
                 lambda: selfsync_decode_device(words, total_bits, gap.table),
                 bool(np.array_equal(np.asarray(selfsync_decode_device(
                     words, total_bits, gap.table)), data))))
    for name, nbytes, fn, ok in rows:
        s = median_seconds(fn, reps)
        emit(dict(op=name, size=nbytes, redundancy=r, exact=ok, seconds=s,
                  gb_per_s=nbytes / s / 1e9, **device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1 << 30)
    ap.add_argument("--redundancy", type=float, nargs="+", default=[0.5, 0.9])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--secondary", action="store_true",
                    help="also time HTC1, Yamamoto and self-sync at --size")
    ap.add_argument("--sweep", action="store_true",
                    help="also time a few Triton launch shapes")
    ap.add_argument("--cpu", action="store_true",
                    help="allow a CPU run (rehearsal only; no device metrics)")
    args = ap.parse_args(argv)

    import jax

    from huffman_jax.backend import platform, setup_compile_cache

    setup_compile_cache()
    plat = platform()
    if plat != "gpu" and not args.cpu:
        print(f"error: platform is {plat!r}, not 'gpu' (pass --cpu to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    if plat == "gpu":
        device["card"] = card()
        print(device["card"], flush=True)
    for r in args.redundancy:
        bench_ils(args.size, r, args.reps, device, interpret=plat == "cpu",
                  sweep=args.sweep and plat == "gpu")
        if args.secondary:
            bench_secondary(args.size, r, args.reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
