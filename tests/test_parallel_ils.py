"""Sharded ILS path on the virtual 8-device CPU mesh (SURVEY §4: multi-host
logic testable with xla_force_host_platform_device_count)."""

import numpy as np
import jax.numpy as jnp
import pytest

from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.core.canonical import chain_spec
from huffman_jax.core.ils_ref import ILS_LANES, ils_schedule_numer
from huffman_jax.models import IlsCodec
from huffman_jax.ops.ils import as_u32_rows
from huffman_jax.ops.ils_xla import ils_dec_tabs, ils_enc_tabs
from huffman_jax.parallel import (
    data_mesh,
    make_ils_sharded_decode,
    make_ils_sharded_roundtrip,
    shard_ils_payload,
)
from huffman_jax.utils import generate_redundant


def _fit(data):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16
    )


def _avg_bits(data, table):
    return float(
        (npref.histogram(data) * table.lengths.astype(np.int64)).sum()
    ) / max(data.size, 1)


def _decoded_bytes(out):
    return np.asarray(out).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_ils_sharded_roundtrip(n_devices):
    mesh = data_mesh(n_devices)
    k, tpd = 8, 2  # tiles per device
    n = n_devices * tpd * k * ILS_LANES
    data = generate_redundant(n, 0.5, seed=7)
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    step = make_ils_sharded_roundtrip(
        mesh, k=k, max_len=max(table.max_len_present, 1),
        min_len=table.min_len, chain=chain_spec(table),
        tiles_per_device=tpd,
    )
    data_dev = jnp.asarray(
        as_u32_rows(data).reshape(n_devices, tpd * (k // 4), ILS_LANES)
    )
    snum = jnp.int32(ils_schedule_numer(_avg_bits(data, table)))
    out, ok = step(data_dev, snum, enc, dec)
    assert int(ok) == 1
    assert np.array_equal(_decoded_bytes(out), data)


def test_ils_sharded_decode_matches_codec():
    n_devices, k, tpd = 4, 8, 3
    mesh = data_mesh(n_devices)
    n = n_devices * tpd * k * ILS_LANES
    data = generate_redundant(n, 0.7, seed=8)
    codec = IlsCodec.fit(data, k=k)
    comp = codec.encode(data)
    (sec,) = comp.sections
    p = sec.params

    payload_dev, starts_dev = shard_ils_payload(
        sec.payload, p.row_starts, n_devices
    )
    dec_fn = make_ils_sharded_decode(
        mesh, k=p.k, min_len=codec.table.min_len,
        chain=chain_spec(codec.table),
        rot=p.rot,  # follow the container's per-section rotation decision
    )
    out = dec_fn(
        jnp.asarray(payload_dev), jnp.asarray(starts_dev), codec.dec
    )
    assert np.array_equal(_decoded_bytes(out), data)


def test_shard_payload_rejects_indivisible():
    with pytest.raises(ValueError):
        shard_ils_payload(
            np.zeros((4, ILS_LANES), np.uint32), np.array([0, 2, 4]), 4
        )


@pytest.mark.parametrize("rot", [False, True])
def test_ils_sharded_certified_pipeline(rot):
    """The production configuration end-to-end over the mesh: pack +
    certification per device, global host certification, per-device row
    gather, sharded decode, bit-exact — and the same certified container
    the single-device encoder writes.  Heterogeneous content (zeros next to
    random) forces real per-window band anchors rather than the trivial
    all-zero schedule."""
    from huffman_jax.ops.ils import ils_encode_device
    from huffman_jax.parallel import ils_sharded_certified_encode

    n_devices, k, tpd = 4, 64, 2
    mesh = data_mesh(n_devices)
    n = n_devices * tpd * k * ILS_LANES
    rng = np.random.default_rng(17)
    data = np.concatenate([
        np.zeros(n // 4, np.uint8),
        rng.integers(0, 256, n // 2).astype(np.uint8),
        np.full(n - n // 4 - n // 2, 65, np.uint8),
    ])
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    avg_bits = _avg_bits(data, table)

    data_dev = jnp.asarray(
        as_u32_rows(data).reshape(n_devices, tpd * (k // 4), ILS_LANES)
    )
    sec = ils_sharded_certified_encode(
        mesh, data_dev, enc, k=k, max_len=max(table.max_len_present, 1),
        avg_bits=avg_bits, tiles_per_device=tpd, rot=rot,
    )
    p = sec.params
    assert p.w_band <= p.w_cap // 2
    one = ils_encode_device(data, table, enc, k=k, avg_bits=avg_bits, rot=rot)
    assert np.array_equal(p.boffs, one.params.boffs)
    assert (p.w_band, p.w_cap) == (one.params.w_band, one.params.w_cap)

    dec_fn = make_ils_sharded_decode(
        mesh, k=k, min_len=table.min_len, chain=chain_spec(table), rot=rot,
    )
    out = dec_fn(sec.payload_dev, sec.starts_dev, dec)
    assert np.array_equal(_decoded_bytes(out), data)


def test_streamed_sections_decode_on_mesh(tmp_path):
    """Section-streamed container + multi-device decode compose: a file
    streamed to disk in bounded sections, then each full section decoded
    over the 8-device mesh with bounded host memory."""
    from huffman_jax.io.container import IlsStreamReader
    from huffman_jax.ops.ils import ils_decode_device

    n_devices, k = 8, 8
    mesh = data_mesh(n_devices)
    tile_bytes = k * ILS_LANES
    section_bytes = n_devices * 2 * tile_bytes  # 16 tiles/section
    n = 3 * section_bytes + 5000  # 3 full sections + a padded tail
    data = generate_redundant(n, 0.5, seed=51)
    src = tmp_path / "src.bin"
    data.tofile(src)

    codec = IlsCodec.fit_file(str(src), k=k)
    cpath = tmp_path / "out.ils"
    codec.encode_file(str(src), str(cpath), section_bytes=section_bytes)

    out = np.zeros(0, np.uint8)
    with open(cpath, "rb") as f:
        reader = IlsStreamReader(f)
        dec = ils_dec_tabs(reader.table)
        while True:
            sec = reader.read_section()
            if sec is None:
                break
            p = sec.params
            if p.n_tiles % n_devices == 0 and p.n_tiles >= n_devices:
                payload_dev, starts_dev = shard_ils_payload(
                    sec.payload, p.row_starts, n_devices
                )
                dec_fn = make_ils_sharded_decode(
                    mesh, k=p.k, min_len=reader.table.min_len,
                    chain=chain_spec(reader.table), rot=p.rot,
                )
                piece = _decoded_bytes(dec_fn(
                    jnp.asarray(payload_dev), jnp.asarray(starts_dev), dec
                ))
            else:  # tail section: single-device decode
                piece = ils_decode_device(sec, reader.table, dec)
            out = np.concatenate([out, piece])
        reader.close()
    assert np.array_equal(out[:n], data)
