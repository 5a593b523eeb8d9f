"""Sharded interleaved-stream codec: tiles over a device mesh.

Multi-device orchestration for the flagship ILS layout (SURVEY §2.7): tiles
are fully independent given the replicated code table, so the tile axis
shards over the mesh's ``data`` axis, each device decodes its contiguous
tile range from its own payload row slice, and the ordered gather of decoded
tiles is simply the output sharding of the jitted step.  Contrast with the
reference's broken multi-GPU split at arbitrary unit boundaries
(`gpuhd/multigpu_demo.cc:186-204`, README "TESTS FAIL"): ILS tiles are
self-contained at *encode* time, so any split at tile granularity is correct
by construction.

Per device the same pack and decode run as on one device (`ops/ils.py`:
the Triton kernels on the GPU, their plain XLA versions on the CPU) under
``shard_map``; only O(n_tiles) metadata crosses to the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import DATA_AXIS, Mesh, P
from ..core.ils_ref import ILS_LANES, IlsParams, ils_n_win, ils_schedule_numer
from ..ops.ils import (
    certify_params,
    ils_decode,
    ils_pack_certify,
    stride_rows_for,
)
from ..ops.ils_xla import ils_compact

__all__ = [
    "shard_ils_payload",
    "make_ils_sharded_decode",
    "make_ils_sharded_roundtrip",
    "ils_sharded_certified_encode",
    "IlsShardedSection",
]


def shard_ils_payload(payload: np.ndarray, row_starts: np.ndarray,
                      n_devices: int):
    """Repartition a compact ILS payload for a D-way tile shard.

    Args:
      payload: (total_rows, 1024) uint32 compact rows.
      row_starts: (n_tiles + 1,) row offset per tile (cumsum of W_t).
      n_devices: D; n_tiles must be a multiple of D.

    Returns (payload_dev (D, R_dev, 1024) uint32, starts_dev (D, T/D + 1)
    int32) with device-local row offsets; shorter devices are zero-padded.
    """
    n_tiles = len(row_starts) - 1
    if n_tiles % n_devices:
        raise ValueError(f"{n_tiles} tiles not divisible by {n_devices} devices")
    tpd = n_tiles // n_devices
    bounds = row_starts[::tpd].astype(np.int64)  # (D + 1,)
    r_dev = int(np.diff(bounds).max())
    payload_dev = np.zeros((n_devices, r_dev, ILS_LANES), np.uint32)
    starts_dev = np.zeros((n_devices, tpd + 1), np.int32)
    for d in range(n_devices):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        payload_dev[d, : hi - lo] = payload[lo:hi]
        starts_dev[d] = row_starts[d * tpd : (d + 1) * tpd + 1] - lo
    return payload_dev, starts_dev


def make_ils_sharded_decode(
    mesh: Mesh,
    *,
    k: int,
    min_len: int,
    chain: tuple,
    rot: bool = False,
):
    """Jitted sharded ILS decode.

    Returns ONE jitted fn(payload_dev, starts_dev, dec) -> (D, T/D * k//4,
    1024) uint32 sharded over the leading axis; reshape(-1) stacks the
    devices' tiles in order, which is the original stream.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None), P()),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,  # pallas_call outputs carry no vma annotation
    )
    def dec_fn(payload_dev, starts_dev, dec):
        out = ils_decode(
            payload_dev[0], starts_dev[0], dec, k=k, min_len=min_len,
            chain=chain, rot=rot,
        )
        return out[None]

    return jax.jit(dec_fn)


class IlsShardedSection:
    """Device-sharded certified section: per-device compact payload + the
    global certified params (uniform w_cap/w_band across devices)."""

    def __init__(self, payload_dev, starts_dev, params: IlsParams):
        self.payload_dev = payload_dev  # (D, R_dev, 1024) uint32
        self.starts_dev = starts_dev  # (D, T/D + 1) int32 local row starts
        self.params = params  # global; boffs is (D*T/D, n_win)


def _pack_fn(mesh, *, k, stride_rows, rot):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(), P()),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None, None),
                   P(DATA_AXIS, None, None), P(DATA_AXIS, None, None)),
        check_vma=False,
    )
    def pack(data_dev, snum, enc):
        pay_s, bits, dn, dx = ils_pack_certify(
            data_dev[0], snum, enc, k=k, stride_rows=stride_rows, rot=rot
        )
        return pay_s[None], bits[None], dn[None], dx[None]

    return pack


def ils_sharded_certified_encode(
    mesh: Mesh,
    data_dev,
    enc,
    *,
    k: int,
    max_len: int,
    avg_bits: float,
    tiles_per_device: int,
    rot: bool = False,
) -> IlsShardedSection:
    """Certified sharded encode.

    data_dev: (D, T/D * k//4, 1024) uint32.  Per device (shard_map over the
    ``data`` axis): pack + schedule certification at worst-case stride,
    with the envelopes reduced to per-(tile, window) scalars on device.  On
    host: ONE global certification over all devices' envelopes (uniform
    w_cap/w_band — the multi-device form of `ops/ils.py::certify_params`).
    Per device again: the row gather to certified row starts.

    This is the encode-time partitioning the reference's prescan demo was
    groping toward (`gpuhd-multigpu/multigpu_demo_prescan.cc:276-319`):
    tiles are self-contained at encode time, so device boundaries are
    always codeword-aligned by construction.
    """
    n_dev = mesh.devices.size
    n_tiles = n_dev * tiles_per_device
    snum = ils_schedule_numer(avg_bits)
    stride_rows = stride_rows_for(k, max_len)

    @jax.jit
    def pack_reduce(data_dev, snum, enc):
        pay_s, bits, dn, dx = _pack_fn(
            mesh, k=k, stride_rows=stride_rows, rot=rot
        )(data_dev, snum, enc)
        w_tiles = jnp.maximum(2 * ((jnp.max(bits, axis=2) + 63) // 64), 4)
        return pay_s, bits, w_tiles, jnp.min(dn, axis=3), jnp.max(dx, axis=3)

    pay_s, bits, w_tiles, dmin, dmax = pack_reduce(
        data_dev, jnp.int32(snum), enc
    )
    w_tiles_h = np.asarray(w_tiles).astype(np.int64)  # (D, tpd)
    params = certify_params(
        k=k, snum=snum, n_tiles=n_tiles,
        w_tiles=w_tiles_h.reshape(-1),
        dec_min=np.asarray(dmin).reshape(n_tiles, ils_n_win(k)),
        dec_max=np.asarray(dmax).reshape(n_tiles, ils_n_win(k)),
        rot=rot,
    )
    starts_local = np.zeros((n_dev, tiles_per_device + 1), np.int32)
    starts_local[:, 1:] = np.cumsum(w_tiles_h, axis=1)
    r_dev = int(starts_local[:, -1].max())

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None, None),
                  P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )
    def compact_fn(pay_s, bits, starts_dev):
        rows = ils_compact(
            pay_s[0], bits[0], starts_dev[0], stride_rows=stride_rows,
            total_rows=r_dev,
        )
        return rows[None]

    starts_dev = jnp.asarray(starts_local)
    payload_dev = jax.jit(compact_fn)(pay_s, bits, starts_dev)
    return IlsShardedSection(payload_dev, starts_dev, params)


def make_ils_sharded_roundtrip(
    mesh: Mesh,
    *,
    k: int,
    max_len: int,
    min_len: int,
    chain: tuple,
    tiles_per_device: int,
    rot: bool = False,
):
    """Full device step over the mesh: ILS pack -> decode -> bit-exact check.

    One jitted program, sharded over all devices, replicated tables,
    ordered recombination, collective verification (pmin).  Tiles stay at
    worst-case stride (no host certification in the step: the decoder
    reads only each stream's own words, so it needs no certified band).
    Returns fn(data_dev (D, T/D*k//4, 1024) uint32, snum, enc, dec) ->
    (decoded, ok).
    """
    stride_rows = stride_rows_for(k, max_len)
    starts = jnp.arange(tiles_per_device + 1, dtype=jnp.int32) * stride_rows

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(), P(), P()),
        out_specs=(P(DATA_AXIS, None, None), P()),
        check_vma=False,
    )
    def step(data_dev, snum, enc, dec):
        local = data_dev[0]
        pay_s, bits, _, _ = ils_pack_certify(
            local, snum, enc, k=k, stride_rows=stride_rows, rot=rot
        )
        rows = ils_compact(
            pay_s, bits, starts, stride_rows=stride_rows,
            total_rows=tiles_per_device * stride_rows,
        )
        out = ils_decode(
            rows, starts, dec, k=k, min_len=min_len, chain=chain, rot=rot
        )
        ok_local = jnp.all(out == local).astype(jnp.int32)
        ok = jax.lax.pmin(ok_local, DATA_AXIS)
        return out[None], ok

    return jax.jit(step)
