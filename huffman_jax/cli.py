"""Command-line interface: generate / encode / decode / roundtrip / bench.

Replaces the reference's per-variant demo binaries (`generate.cpp` CLI,
`gpuhd/src/demo.cc`, `Huffman_coding_Gap_arrays/run_huffman.sh`) with one
entry point::

    python -m huffman_jax.cli generate --size 100000000 --redundancy 0.5 -o data.bin
    python -m huffman_jax.cli encode data.bin -o data.htc
    python -m huffman_jax.cli decode data.htc -o out.bin
    python -m huffman_jax.cli roundtrip data.bin
    python -m huffman_jax.cli bench --size 268435456 --redundancy 0.5
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _add_codec_args(p):
    p.add_argument("--max-len", type=int, default=16)
    p.add_argument("--seg-bits", type=int, default=None)
    p.add_argument("--block-bytes", type=int, default=None)
    p.add_argument(
        "--format", choices=["ils", "htc1", "yamamoto", "seq"], default="ils",
        help="container: ils (flagship), htc1 (gap-array), "
             "yamamoto (reference gap-array container), "
             "seq (reference sequential.cpp blob)",
    )
    p.add_argument(
        "--k", type=int, default=None,
        help="ILS symbols per stream (default: auto from mean code length)",
    )
    p.add_argument(
        "--optimize", choices=["speed", "ratio"], default="speed",
        help="ILS k policy: narrow refill band (speed) or minimal padding (ratio)",
    )
    p.add_argument(
        "--method", choices=["lut", "canonical", "twolevel"], default="lut",
        help="htc1/yamamoto decode inner-step implementation",
    )
    p.add_argument(
        "--rotate", choices=["auto", "on", "off"], default="auto",
        help="ILS lane-decorrelation rotation: auto (default) turns it on "
             "per section only when it narrows the certified band; off "
             "writes a v3 container readable by older decoders",
    )


class _RefFormatCodec:
    """Adapter: reference-format blobs behind the codec interface."""

    def __init__(self, fmt, data, max_len, method="lut"):
        from .core import npref
        from .core.canonical import canonical_code_table
        from .core.package_merge import package_merge_lengths

        self.fmt = fmt
        self.method = method
        self.table = canonical_code_table(
            package_merge_lengths(npref.histogram(data), max_len), max_len
        )

    def encode(self, data):
        from .io.seqfmt import write_seq
        from .io.yamamoto import write_yamamoto

        if self.fmt == "seq":
            return write_seq(data, self.table)
        return write_yamamoto(data, self.table)

    def decode(self, blob):
        from .io.seqfmt import decode_seq
        from .io.yamamoto import decode_yamamoto

        if self.fmt == "seq":
            return decode_seq(blob)
        return decode_yamamoto(blob, method=self.method)


def _make_codec(args, data):
    if args.format in ("yamamoto", "seq"):
        return _RefFormatCodec(
            args.format, data, args.max_len, method=args.method
        )
    if args.format == "ils":
        from .models import IlsCodec

        return IlsCodec.fit(
            data, max_len=args.max_len, k=args.k,
            optimize=getattr(args, "optimize", "speed"),
            rotate={"auto": "auto", "on": True, "off": False}[
                getattr(args, "rotate", "auto")
            ],
        )
    from .models import GapArrayCodec

    return GapArrayCodec.fit(data, **_codec_kwargs(args))


def _write_blob(args, comp):
    if args.format in ("yamamoto", "seq"):
        return comp  # _RefFormatCodec.encode already returns bytes
    if args.format == "ils":
        from .io import write_ils_container

        return write_ils_container(comp)
    from .io import write_container

    return write_container(comp)


def _codec_kwargs(args):
    from .constants import DEFAULT_BLOCK_BYTES, SEG_BITS

    return dict(
        max_len=args.max_len,
        seg_bits=args.seg_bits or SEG_BITS,
        block_bytes=args.block_bytes or DEFAULT_BLOCK_BYTES,
        method=args.method,
    )


def cmd_generate(args):
    from .utils import generate_redundant

    data = generate_redundant(args.size, args.redundancy, seed=args.seed)
    with open(args.output, "wb") as f:
        f.write(data.tobytes())
    print(f"Generated {args.size} bytes in {args.output}")


def cmd_encode(args):
    if getattr(args, "stream", False):
        if args.format != "ils":
            print("error: --stream requires --format ils", file=sys.stderr)
            sys.exit(1)
        import os

        from .models import IlsCodec

        t0 = time.perf_counter()
        codec = IlsCodec.fit_file(
            args.input, max_len=args.max_len, k=args.k,
            optimize=args.optimize,
            rotate={"auto": "auto", "on": True, "off": False}[args.rotate],
        )
        csize = codec.encode_file(
            args.input, args.output, section_bytes=args.section_bytes
        )
        dt = time.perf_counter() - t0
        n = os.path.getsize(args.input)
        print(f"Original size:   {n} bytes")
        print(f"Compressed size: {csize} bytes")
        print(f"Ratio:           {100.0 * csize / max(n, 1):.2f}%")
        print(f"Encode time:     {dt * 1e3:.1f} ms "
              f"({n / dt / 1e9:.3f} GB/s inc. fit+IO, section-streamed)")
        return
    data = np.fromfile(args.input, np.uint8)
    t0 = time.perf_counter()
    codec = _make_codec(args, data)
    comp = codec.encode(data)
    blob = _write_blob(args, comp)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"Original size:   {data.size} bytes")
    print(f"Compressed size: {len(blob)} bytes")
    print(f"Ratio:           {100.0 * len(blob) / max(data.size, 1):.2f}%")
    print(f"Encode time:     {dt * 1e3:.1f} ms ({data.size / dt / 1e9:.3f} GB/s inc. fit+IO)")


def cmd_decode(args):
    from .io import container_kind, read_container, read_ils_container

    if getattr(args, "stream", False):
        from .models import IlsCodec

        t0 = time.perf_counter()
        n = IlsCodec.decode_file(args.input, args.output)
        dt = time.perf_counter() - t0
        print(f"Decompressed {n} bytes in {dt * 1e3:.1f} ms "
              f"({n / dt / 1e9:.3f} GB/s inc. IO, section-streamed)")
        return
    blob = open(args.input, "rb").read()
    fmt = getattr(args, "format", "ils")
    if fmt in ("yamamoto", "seq"):
        from .io.seqfmt import decode_seq
        from .io.yamamoto import decode_yamamoto

        t0 = time.perf_counter()
        out = (
            decode_seq(blob)
            if fmt == "seq"
            else decode_yamamoto(blob, method=args.method)
        )
        dt = time.perf_counter() - t0
        out.tofile(args.output)
        print(f"Decompressed {out.size} bytes in {dt * 1e3:.1f} ms "
              f"({fmt} reference format)")
        return
    try:
        kind = container_kind(blob)
        if kind == "ils1":
            from .models import IlsCodec

            comp = read_ils_container(blob)
            codec = IlsCodec(comp.table)
        else:
            from .models import GapArrayCodec

            comp = read_container(blob)
            codec = GapArrayCodec(
                comp.table, seg_bits=comp.seg_bits, block_bytes=comp.block_bytes,
                method=args.method,
            )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    out = codec.decode(comp)
    dt = time.perf_counter() - t0
    out.tofile(args.output)
    print(f"Decompressed {out.size} bytes in {dt * 1e3:.1f} ms "
          f"({out.size / dt / 1e9:.3f} GB/s inc. host staging)")


def cmd_roundtrip(args):
    from .io import read_container, read_ils_container

    data = np.fromfile(args.input, np.uint8)
    codec = _make_codec(args, data)
    blob = _write_blob(args, codec.encode(data))
    if args.format in ("yamamoto", "seq"):
        out = codec.decode(blob)
    elif args.format == "ils":
        out = codec.decode(read_ils_container(blob))
    else:
        out = codec.decode(read_container(blob))
    ok = np.array_equal(out, data)
    print(f"Original size:   {data.size} bytes")
    print(f"Compressed size: {len(blob)} bytes "
          f"({100.0 * len(blob) / max(data.size, 1):.2f}%)")
    print(f"Verification:    {'PASS' if ok else 'FAIL'}")
    if not ok:
        bad = np.nonzero(out != data)[0]
        i = int(bad[0])
        print(f"first difference at byte {i}: got {out[i]}, expected {data[i]}")
        sys.exit(1)


def cmd_bench(args):
    from .utils import generate_redundant
    from .utils.timing import bench_fn

    data = generate_redundant(args.size, args.redundancy, seed=args.seed)
    codec = _make_codec(args, data)
    comp = codec.encode(data)
    enc = bench_fn("encode", lambda: codec.encode(data), data.size,
                   warmup=args.warmup, repeat=args.repeat)
    dec = bench_fn("decode", lambda: codec.decode(comp), data.size,
                   warmup=args.warmup, repeat=args.repeat)
    ok = np.array_equal(codec.decode(comp), data)
    print(enc)
    print(dec)
    print(f"verification: {'PASS' if ok else 'FAIL'}")


def main(argv=None):
    from .backend import platform, setup_compile_cache

    platform()  # gpu or cpu; anything else fails here, not mid-command
    setup_compile_cache()
    ap = argparse.ArgumentParser(prog="huffman_jax")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("generate", help="write synthetic data (generate.cpp semantics)")
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--redundancy", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default="data.bin")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("encode", help="compress a file to an HTC1 container")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--stream", action="store_true",
        help="section-streamed encode with bounded host memory "
             "(ILS format; use --section-bytes to size sections)",
    )
    p.add_argument("--section-bytes", type=int, default=None)
    _add_codec_args(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decompress a container (auto-detects ILS1/HTC1)")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--stream", action="store_true",
        help="section-streamed decode with bounded host memory (ILS1)",
    )
    p.add_argument(
        "--method", choices=["lut", "canonical", "twolevel"], default="lut",
        help="htc1/yamamoto decode inner-step implementation",
    )
    p.add_argument(
        "--format", choices=["auto", "yamamoto", "seq"], default="auto",
        help="force a reference format (these have no magic bytes)",
    )
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="encode+decode+verify a file")
    p.add_argument("input")
    _add_codec_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser("bench", help="throughput benchmark on synthetic data")
    p.add_argument("--size", type=int, default=1 << 28)
    p.add_argument("--redundancy", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--repeat", type=int, default=5)
    _add_codec_args(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
