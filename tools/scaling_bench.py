"""Multi-device scaling benchmark: sharded ILS decode over 1..N devices.

Measures BASELINE configs 4/5 (multi-device data-parallel decode with
ordered gather) on whatever GPUs are present: four cards report scaling
efficiency; one card degenerates to the 1-device row.  A CPU host can
rehearse the code path with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
python tools/scaling_bench.py --size $((1<<24)) --cpu`` (no device metrics).

Usage:
    python tools/scaling_bench.py [--size BYTES] [--redundancy R] [--k K]

Prints one JSON line per device count with decode GB/s (median of
``--reps``, ``jax.block_until_ready``) and efficiency relative to the
1-device run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1 << 27)
    ap.add_argument("--redundancy", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="allow a CPU rehearsal (no device metrics)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from huffman_jax.backend import platform, setup_compile_cache
    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.core.ils_ref import ILS_LANES
    from huffman_jax.models import IlsCodec
    from huffman_jax.ops.ils import as_u32_rows, ils_encode_to_device
    from huffman_jax.parallel import data_mesh, make_ils_sharded_decode
    from huffman_jax.utils import generate_redundant
    from huffman_jax.utils.distributed import init_multihost

    setup_compile_cache()
    if platform() != "gpu" and not args.cpu:
        sys.exit("error: not on a GPU (pass --cpu to rehearse)")
    init_multihost()
    n_dev = len(jax.devices())
    print(f"devices: {n_dev}", file=sys.stderr)

    codec0 = IlsCodec.fit(
        generate_redundant(1 << 20, args.redundancy, seed=0), k=args.k
    )
    k = codec0.k
    tile_bytes = k * ILS_LANES
    # tile count divisible by every device count we test
    n_tiles = max(args.size // tile_bytes, 1)
    n_tiles -= n_tiles % n_dev or 0
    n_tiles = max(n_tiles, n_dev)
    size = n_tiles * tile_bytes
    data = generate_redundant(size, args.redundancy, seed=0)
    codec = IlsCodec.fit(data, k=k)

    payload_rows, _, p = ils_encode_to_device(
        jnp.asarray(as_u32_rows(data)), codec.enc, k=k,
        avg_bits=codec._avg_bits(data), max_len=codec.table.max_len_present,
    )
    payload = np.asarray(payload_rows)

    from huffman_jax.parallel.ils import shard_ils_payload

    base_gbps = None
    counts = [d for d in range(1, n_dev + 1) if n_tiles % d == 0]
    for d in counts:
        mesh = data_mesh(d)
        payload_dev, starts_dev = shard_ils_payload(
            payload, p.row_starts, d
        )
        dec_fn = make_ils_sharded_decode(
            mesh, k=p.k, min_len=codec.table.min_len,
            chain=chain_spec(codec.table), rot=p.rot,
        )
        pd = jnp.asarray(payload_dev)
        sd = jnp.asarray(starts_dev)

        def run():
            return dec_fn(pd, sd, codec.dec)

        jax.block_until_ready(run())
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            ts.append(time.perf_counter() - t0)
        ts.sort()
        t = ts[len(ts) // 2]
        gbps = size / t / 1e9
        if base_gbps is None:
            base_gbps = gbps
        eff = gbps / (base_gbps * d)
        print(json.dumps({
            "devices": d, "decode_gbps": round(gbps, 3),
            "efficiency_vs_1dev": round(eff, 3), "size_bytes": size,
        }))


if __name__ == "__main__":
    main()
