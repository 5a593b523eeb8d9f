"""Device orchestration for the interleaved-stream (ILS) codec.

Encode = ONE pack pass that also certifies the decoder's refill schedule,
then a row gather to the certified tile offsets; decode = ONE pass whose
u32 output *is* the original data (see `core/ils_ref.py` for the layout).
Both run the Triton kernels on the GPU and their plain XLA versions on the
CPU (`backend.use_kernels`).  These functions speak NumPy at the boundary —
the byte<->u32 reinterpretation is a zero-copy little-endian view on the
host, so device code never touches a sub-word gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .. import backend
from ..core.canonical import CodeTable, chain_spec
from ..core.ils_ref import (
    ILS_LANES,
    IlsParams,
    ils_schedule_numer,
    round_band,
    round_cap,
)
from .ils_xla import (
    IlsDecTabs,
    IlsEncTabs,
    ils_compact,
    ils_decode_xla,
    ils_pack_certify_xla,
)

__all__ = [
    "IlsSection",
    "IlsVmemError",
    "certify_params",
    "ils_decode",
    "ils_pack_certify",
    "ils_encode_device",
    "ils_encode_to_device",
    "ils_decode_device",
    "round_band",
    "round_cap",
]

# Row budget per tile: the largest w_cap the encoder's k policy accepts
# before it halves k (`models/ils_codec.py`).  It fixes which k a container
# holds for a given file, so it stays as it is until the policy is
# re-derived for the GPU (ROADMAP).
VMEM_ROW_BUDGET = 2800

# smallest k the retry path falls back to (a 2048-symbol stream is at most
# 1024 words, always within budget)
MIN_K = 2048


def auto_rot_band(k: int) -> int:
    """rot="auto": bands at or under this many pairs never re-encode with
    rotation.  Wider bands are the signature of lane-correlated content
    (content periodic in the 4 KB lane stride), so the encoder retries
    rotated and keeps whichever band is strictly narrower.  The schedule
    deviation of lane-uncorrelated content grows ~sqrt(k) (a random walk
    over the stream), so the threshold scales the same way from 32 pairs at
    k=4096."""
    return max(round_band(int(32 * (k / 4096) ** 0.5)), 8)


class IlsVmemError(ValueError):
    """Tile shape exceeds the row budget; retry with a smaller k."""


def pick_k(avg_bits: float, optimize: str = "speed") -> int:
    """Choose k (symbols per stream) for the table's mean code length.

    Larger k amortizes per-stream padding (ratio improves ~1/sqrt(k)) but
    widens the refill band (~sqrt(k)).  ``optimize="speed"`` caps k at 4096;
    ``optimize="ratio"`` uses the largest k whose estimated row count fits
    the row budget.
    """
    max_k = 4096 if optimize == "speed" else 16384
    best = 2048
    for k in (2048, 4096, 8192, 16384):
        if k > max_k:
            break
        w_est = round_cap(int(k * max(avg_bits, 1.0) / 32 * 1.10) + 8)
        if w_est <= VMEM_ROW_BUDGET:
            best = k
    return best


def certify_params(
    *,
    k: int,
    snum: int,
    n_tiles: int,
    w_tiles: np.ndarray,
    dec_min: np.ndarray,
    dec_max: np.ndarray,
    rot: bool = False,
) -> IlsParams:
    """Turn measured schedule envelopes into certified container params.

    The refill window ``[base, base + band)`` must fit the tile's pair
    capacity (``band <= w_cap // 2``).  When the measured envelope needs
    more, the cap is WIDENED — the extra rows are pure zero slack — rather
    than the band narrowed below the envelope, which would break the
    container invariant `core/ils_ref.py::ils_decode_np` enforces.  Raises
    ``IlsVmemError`` when even the widened cap exceeds the row budget (the
    codec retries with a smaller k).  Same rule as `ils_encode_np`.
    """
    w_cap = round_cap(int(w_tiles.max()))
    dec_span = int(np.maximum(dec_max - dec_min, 0).max(initial=0))
    w_band = round_band(dec_span + 2)  # in pairs
    if 2 * w_band > w_cap:
        w_cap = round_cap(2 * w_band)
    if w_cap > VMEM_ROW_BUDGET and k > MIN_K:
        # at MIN_K the budget always fits: k=2048 bounds both the storage
        # rows (2*ceil(2048*16/64) = 1024) and the widened band cap
        # (round_cap(2*round_band(span+2)) <= 1280) well under it
        raise IlsVmemError(
            f"k={k} with w_cap={w_cap} exceeds the row budget; "
            "re-encode with a smaller k"
        )
    boffs = np.where(dec_min <= dec_max, dec_min, 0).astype(np.int32)
    return IlsParams(
        k=k, snum=snum, boffs=boffs, w_band=int(w_band),
        w_cap=int(w_cap), w_tiles=w_tiles.astype(np.int32),
        n_tiles=n_tiles, rot=rot,
    )


@dataclasses.dataclass
class IlsSection:
    """One uniform-k run of tiles plus its interleaved payload."""

    params: IlsParams
    payload: np.ndarray  # (total_rows, 1024) uint32

    @property
    def nbytes_payload(self) -> int:
        return int(self.payload.nbytes)


def ils_pack_certify(data, snum, enc: IlsEncTabs, *, k, stride_rows,
                     rot=False):
    """Pack + certify on the active backend (`ops/ils_xla.py` contract)."""
    if backend.use_kernels():
        from .pallas.ils_kernels import ils_pack_certify_triton

        return ils_pack_certify_triton(
            data, snum, enc, k=k, stride_rows=stride_rows, rot=rot
        )
    return ils_pack_certify_xla(
        data, snum, enc, k=k, stride_rows=stride_rows, rot=rot
    )


def ils_decode(payload, row_starts, dec: IlsDecTabs, *, k, min_len, chain,
               rot=False):
    """Decode on the active backend (`ops/ils_xla.py` contract)."""
    if backend.use_kernels():
        from .pallas.ils_kernels import ils_decode_triton

        return ils_decode_triton(
            payload, row_starts, dec, k=k, min_len=min_len, chain=chain,
            rot=rot,
        )
    return ils_decode_xla(
        payload, row_starts, dec, k=k, min_len=min_len, chain=chain, rot=rot
    )


def stride_rows_for(k: int, max_len: int) -> int:
    """Worst-case rows per tile: every symbol at the longest code."""
    return max(2 * (-(-k * max_len // 64)), 4)


def ils_encode_to_device(
    data_u32,
    enc: IlsEncTabs,
    *,
    k: int,
    avg_bits: float,
    max_len: int | None = None,
    rot: bool | str = False,
):
    """Device-resident encode: returns (payload_rows, row_starts_dev, params).

    data_u32: (n_tiles * k // 4, 1024) uint32 on device.  payload_rows
    (total_rows, 1024) uint32 stays on device; only per-tile metadata syncs
    to the host.

    ``rot="auto"`` (the library default) chooses the lane-decorrelation
    rotation per section from the measured schedule envelope: encode
    unrotated first; if the certified band exceeds ``auto_rot_band(k)``
    (the signature of lane-correlated content), re-encode rotated and keep
    whichever band is strictly narrower.
    """
    if rot == "auto":
        res_plain = ils_encode_to_device(
            data_u32, enc, k=k, avg_bits=avg_bits, max_len=max_len, rot=False
        )
        if res_plain[2].w_band <= auto_rot_band(k):
            return res_plain
        res_rot = ils_encode_to_device(
            data_u32, enc, k=k, avg_bits=avg_bits, max_len=max_len, rot=True
        )
        return res_rot if res_rot[2].w_band < res_plain[2].w_band else res_plain

    n_tiles = data_u32.shape[0] // (k // 4)
    snum = ils_schedule_numer(avg_bits)
    if max_len is None:
        max_len = int(np.asarray(enc.packed).max()) >> 20
    stride_rows = stride_rows_for(k, max_len)
    pay_s, bits, dn, dx = ils_pack_certify(
        data_u32, jnp.int32(snum), enc, k=k, stride_rows=stride_rows,
        rot=bool(rot),
    )
    # even word counts (pair granularity), >= 4 for the 128-bit register
    # init; the envelopes reduce over lanes on device
    w_tiles = np.asarray(
        jnp.maximum(2 * ((jnp.max(bits, axis=1) + 63) // 64), 4)
    ).astype(np.int64)
    params = certify_params(
        k=k, snum=snum, n_tiles=n_tiles, w_tiles=w_tiles,
        dec_min=np.asarray(jnp.min(dn, axis=2)),
        dec_max=np.asarray(jnp.max(dx, axis=2)),
        rot=bool(rot),
    )
    row_starts_dev = jnp.asarray(params.row_starts)
    payload_rows = ils_compact(
        pay_s, bits, row_starts_dev, stride_rows=stride_rows,
        total_rows=params.total_rows,
    )
    return payload_rows, row_starts_dev, params


def as_u32_rows(data: np.ndarray) -> np.ndarray:
    """Flat bytes (multiple of 4096) -> (rows, 1024) uint32 view."""
    return np.ascontiguousarray(data, np.uint8).view("<u4").reshape(
        -1, ILS_LANES
    )


def ils_encode_device(
    data: np.ndarray,
    table: CodeTable,
    enc: IlsEncTabs,
    *,
    k: int,
    avg_bits: float,
    rot: bool | str = False,
) -> IlsSection:
    """Encode flat bytes (size must be a multiple of k*1024) into one
    section whose container fields match `core/ils_ref.py::ils_encode_np`
    bit for bit."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size % (k * ILS_LANES):
        raise ValueError("data size must be a multiple of k * 1024")
    payload_rows, _, params = ils_encode_to_device(
        jnp.asarray(as_u32_rows(data)), enc, k=k, avg_bits=avg_bits,
        max_len=int(table.max_len_present), rot=rot,
    )
    return IlsSection(params=params, payload=np.asarray(payload_rows))


def ils_decode_device(
    section: IlsSection, table: CodeTable, dec: IlsDecTabs
) -> np.ndarray:
    """Decode one section back to flat bytes (n_tiles * k * 1024 of them)."""
    p = section.params
    if not (1 <= p.w_band <= p.w_cap // 2):
        # our encoder guarantees this (certify_params widens w_cap); a
        # foreign or corrupted container is rejected, not decoded
        raise ValueError(
            f"invalid ILS section: w_band={p.w_band} outside "
            f"[1, w_cap//2={p.w_cap // 2}]"
        )
    out = ils_decode(
        jnp.asarray(section.payload.reshape(-1, ILS_LANES)),
        jnp.asarray(p.row_starts),
        dec,
        k=p.k,
        min_len=max(table.min_len, 1),
        chain=chain_spec(table),
        rot=p.rot,
    )
    return np.asarray(out).reshape(-1).view("<u4").view(np.uint8)
