"""Interleaved-stream (ILS) codec tests: oracle equivalence of the device
path (the plain XLA versions on this CPU backend), codec round-trips,
container round-trips.

The reference has no test framework (SURVEY §4); its pattern is the
self-verifying round-trip in every main().  Here the pure-NumPy oracle
(`core/ils_ref.py`) is additionally checked bit-for-bit against the device
encode and decode so both are pinned down independently; the Triton
kernels are checked against both in `test_ils_kernels.py`.
"""

import numpy as np
import pytest

from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.core.ils_ref import (
    ILS_LANES,
    ils_decode_np,
    ils_encode_np,
    ils_simulate_schedule,
    ils_stream_symbols,
)
from huffman_jax.io import (
    container_kind,
    read_ils_container,
    write_ils_container,
)
from huffman_jax.models import IlsCodec
from huffman_jax.ops.ils import ils_decode_device, ils_encode_device
from huffman_jax.ops.ils_xla import ils_dec_tabs, ils_enc_tabs
from huffman_jax.utils import generate_redundant


def _fit(data, max_len=16):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), max_len), max_len
    )


def test_stream_symbols_layout():
    k = 8
    n = 2 * k * ILS_LANES
    data = np.arange(n, dtype=np.uint32).astype(np.uint8)
    syms = ils_stream_symbols(data, k)
    assert syms.shape == (2, k, ILS_LANES)
    # symbol 4r+j of stream s in tile t is byte j of u32 word (t*k/4 + r)*1024 + s
    u32 = data.view("<u4")
    for t, r, j, s in [(0, 0, 0, 0), (0, 1, 2, 5), (1, 0, 3, 1023)]:
        w = int(u32[(t * (k // 4) + r) * ILS_LANES + s])
        assert syms[t, 4 * r + j, s] == ((w >> (8 * j)) & 255)


@pytest.mark.parametrize("r", [0.0, 0.5, 0.95])
@pytest.mark.parametrize("k", [8, 20])
def test_oracle_roundtrip(r, k):
    n = 3 * k * ILS_LANES
    data = generate_redundant(n, r, seed=3)
    table = _fit(data)
    payload, params = ils_encode_np(data, table, k)
    out = ils_decode_np(payload, params, table)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("r", [0.0, 0.5, 0.9])
def test_kernels_match_oracle(r, rot):
    k = 12
    n = 2 * k * ILS_LANES
    data = generate_redundant(n, r, seed=4)
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    avg = float(table.lengths.astype(np.int64)[data].mean())

    payload_np, params_np = ils_encode_np(data, table, k, rot=rot)
    sec = ils_encode_device(
        data, table, enc, k=k, avg_bits=avg, rot=rot
    )
    assert sec.params.snum == params_np.snum
    assert np.array_equal(sec.params.boffs, params_np.boffs)
    assert sec.params.w_band == params_np.w_band
    assert np.array_equal(sec.params.w_tiles, params_np.w_tiles)
    assert sec.params.w_cap == params_np.w_cap
    assert sec.params.rot == rot
    assert np.array_equal(sec.payload, payload_np)

    out = ils_decode_device(sec, table, dec)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("r", [0.1, 0.5, 0.9])
def test_decode_chain_spec_matches_dense(r):
    # the grouped compare chain (one weighted compare per distinct decode
    # limit, `core/canonical.py::chain_spec`) must be bit-identical to the
    # dense per-level chain at every redundancy
    from huffman_jax.core.canonical import chain_spec
    from huffman_jax.ops.ils import as_u32_rows, ils_decode, ils_encode_to_device
    import jax.numpy as jnp

    k = 12
    n = 2 * k * ILS_LANES
    data = generate_redundant(n, r, seed=13)
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    spec = chain_spec(table)
    # grouped spec must cover [min_len, max_len_present) with its weights
    assert sum(w for _, w in spec) == max(
        table.max_len_present - table.min_len, 0
    )
    avg = float(table.lengths.astype(np.int64)[data].mean())
    data_u32 = jnp.asarray(as_u32_rows(data))
    rows, starts, p = ils_encode_to_device(data_u32, enc, k=k, avg_bits=avg)
    dense = tuple(
        (l, 1) for l in range(table.min_len, table.max_len_present)
    )
    for chain in (dense, spec):
        out = ils_decode(rows, starts, dec, k=p.k, min_len=table.min_len,
                         chain=chain, rot=p.rot)
        assert np.array_equal(np.asarray(out), np.asarray(data_u32))


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_decode_odd_tile_counts(n_tiles):
    # one tile and an odd tile count through the whole device path
    k = 12
    n = n_tiles * k * ILS_LANES
    data = generate_redundant(n, 0.5, seed=9)
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    avg = float(table.lengths.astype(np.int64)[data].mean())
    sec = ils_encode_device(data, table, enc, k=k, avg_bits=avg)
    out = ils_decode_device(sec, table, dec)
    assert np.array_equal(out, data)


def test_schedule_simulation_envelope():
    # all-same-symbol input: zero deviation from a constant-length schedule
    k = 16
    data = np.full(k * ILS_LANES, 7, np.uint8)
    table = _fit(data)
    lens = table.lengths[ils_stream_symbols(data, k)].astype(np.int64)
    bits, dec_min, dec_max, enc_min, enc_max = ils_simulate_schedule(
        lens, 65536 // 8
    )  # 1 bit/sym
    assert np.all(bits == k * int(table.lengths[7]))
    assert int((dec_max - dec_min).max()) <= 4
    assert int((enc_max - enc_min).max()) <= 4


@pytest.mark.parametrize("n_extra", [-1, 0, 1, 4095, 4096, 70000])
def test_codec_roundtrip_sizes(n_extra):
    k = 8
    n = k * ILS_LANES + n_extra
    data = generate_redundant(n, 0.5, seed=5)
    codec = IlsCodec.fit(data, k=k)
    comp = codec.encode(data)
    out = codec.decode(comp)
    assert np.array_equal(out, data)


def test_codec_empty():
    codec = IlsCodec.fit(np.zeros(0, np.uint8), k=8)
    comp = codec.encode(np.zeros(0, np.uint8))
    assert codec.decode(comp).size == 0


def test_container_roundtrip():
    k = 8
    data = generate_redundant(k * ILS_LANES + 777, 0.6, seed=6)
    codec = IlsCodec.fit(data, k=k)
    comp = codec.encode(data)
    blob = write_ils_container(comp)
    assert container_kind(blob) == "ils1"
    assert len(blob) == comp.compressed_bytes
    comp2 = read_ils_container(blob)
    assert comp2.original_size == data.size
    assert np.array_equal(comp2.table.lengths, comp.table.lengths)
    out = codec.decode(comp2)
    assert np.array_equal(out, data)


def test_container_rejects_garbage():
    with pytest.raises(ValueError):
        read_ils_container(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError):
        container_kind(b"ZZZZ")


def test_container_detects_corruption():
    k = 8
    data = generate_redundant(k * ILS_LANES, 0.5, seed=9)
    codec = IlsCodec.fit(data, k=k)
    blob = bytearray(write_ils_container(codec.encode(data)))
    blob[-5] ^= 0x40  # flip a payload bit
    with pytest.raises(ValueError, match="checksum"):
        read_ils_container(bytes(blob))


def test_container_version_follows_rotation():
    # rotate=False keeps writing v3 (older readers stay compatible);
    # rotate=True requires v4 so a v3 reader rejects it rather than
    # silently mis-decoding a rotated layout (the default "auto" writes
    # whichever version matches its per-section decision)
    k = 8
    data = generate_redundant(k * ILS_LANES, 0.5, seed=13)
    for rotate, version in ((False, 3), (True, 4)):
        codec = IlsCodec.fit(data, k=k, rotate=rotate)
        comp = codec.encode(data)
        blob = write_ils_container(comp)
        assert blob[4] == version
        comp2 = read_ils_container(blob)
        assert comp2.sections[0].params.rot == rotate
        assert np.array_equal(codec.decode(comp2), data)


def test_container_rejects_unknown_section_flags():
    k = 8
    data = generate_redundant(k * ILS_LANES, 0.5, seed=13)
    codec = IlsCodec.fit(data, k=k, rotate=False)
    blob = bytearray(write_ils_container(codec.encode(data)))
    # flags i32 sits 8 bytes into the first section struct
    off = blob.index(b"ILS1") + 21 + 2 * codec.table.num_symbols + 8
    blob[off] = 0x02
    with pytest.raises(ValueError, match="flags|checksum"):
        read_ils_container(bytes(blob))
    # a v3 container reserves the flags word as zero: a flipped rotation
    # bit (legal only from v4) must be rejected, not silently decoded
    # rotated (the payload CRC cannot see section metadata)
    blob[off] = 0x01
    with pytest.raises(ValueError, match="flags|checksum"):
        read_ils_container(bytes(blob))


def test_rotation_decorrelates_periodic_content():
    # content periodic in the 4 KB lane stride is the adversarial case the
    # rotation exists for: without it every stream sees one fixed content
    # column (skewed per-lane entropy -> wide band, long max stream);
    # with it the skew folds across streams
    k = 64
    n = 2 * k * ILS_LANES
    period = np.frombuffer(np.random.default_rng(0).bytes(4096), np.uint8)
    period = period.copy()
    period.reshape(8, 512)[::2] = 0  # half the 512 B sub-blocks low-entropy
    data = np.tile(period, n // 4096)
    table = _fit(data)
    _, p_plain = ils_encode_np(data, table, k, rot=False)
    _, p_rot = ils_encode_np(data, table, k, rot=True)
    assert p_rot.w_band < p_plain.w_band
    assert p_rot.total_rows < p_plain.total_rows  # less per-tile padding
    # and the kernels agree with the oracle on this adversarial input
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    avg = float(table.lengths.astype(np.int64)[data].mean())
    sec = ils_encode_device(
        data, table, enc, k=k, avg_bits=avg, rot=True
    )
    payload_np, params_np = ils_encode_np(data, table, k, rot=True)
    assert np.array_equal(sec.payload, payload_np)
    assert np.array_equal(
        ils_decode_device(sec, table, dec), data
    )


def test_auto_rotation_follows_content():
    # rotate="auto" (the library default) pays the rotation rolls only when
    # they buy band narrowing: lane-periodic content (the test above) must
    # come out rotated, generic content unrotated (ops/ils.py::auto_rot_band)
    k = 64
    n = 2 * k * ILS_LANES
    period = np.frombuffer(np.random.default_rng(0).bytes(4096), np.uint8)
    period = period.copy()
    period.reshape(8, 512)[::2] = 0
    periodic = np.tile(period, n // 4096)
    generic = generate_redundant(n, 0.5, seed=3)
    for data, want_rot in ((periodic, True), (generic, False)):
        codec = IlsCodec.fit(data, k=k)  # rotate="auto"
        comp = codec.encode(data)
        assert [s.params.rot for s in comp.sections] == [want_rot]
        # the auto decision matches what an explicit encode certifies
        forced = IlsCodec.fit(data, k=k, rotate=not want_rot)
        fband = forced.encode(data).sections[0].params.w_band
        ours = comp.sections[0].params.w_band
        assert (ours < fband) if want_rot else (ours <= fband)
        assert np.array_equal(codec.decode(comp), data)


def test_codec_multi_section(monkeypatch):
    k = 8
    data = generate_redundant(5 * k * ILS_LANES + 100, 0.5, seed=10)
    codec = IlsCodec.fit(data, k=k)
    monkeypatch.setattr(IlsCodec, "SECTION_BYTES", 2 * k * ILS_LANES)
    comp = codec.encode(data)
    assert len(comp.sections) == 4  # 2+2+1 full tiles, then the tail
    blob = write_ils_container(comp)
    assert np.array_equal(codec.decode(read_ils_container(blob)), data)


# ----------------------------------------------------------------------
# Band certification: the window must always cover the measured envelope
# ----------------------------------------------------------------------
def test_certify_widens_cap_instead_of_clamping_band():
    # Synthetic envelope whose span exceeds half the storage-driven cap:
    # round-1 code silently clamped w_band to w_cap//2 (corrupting the
    # stream with no error); certify_params must widen w_cap instead.
    from huffman_jax.ops.ils import certify_params

    w_tiles = np.array([64], np.int64)  # storage cap would be 64 rows
    dec_min = np.array([[0]], np.int64)
    dec_max = np.array([[100]], np.int64)  # span 100 pairs > 64//2
    p = certify_params(
        k=2048, snum=1 << 16, n_tiles=1, w_tiles=w_tiles,
        dec_min=dec_min, dec_max=dec_max,
    )
    assert p.w_band >= 102
    assert p.w_band <= p.w_cap // 2
    assert p.w_cap >= 2 * p.w_band


def test_certify_raises_vmem_beyond_budget():
    from huffman_jax.ops.ils import IlsVmemError, certify_params

    with pytest.raises(IlsVmemError):
        certify_params(
            k=4096, snum=1 << 16, n_tiles=1,
            w_tiles=np.array([64], np.int64),
            dec_min=np.array([[0]], np.int64),
            dec_max=np.array([[3000]], np.int64),
        )


def test_decode_rejects_invalid_band():
    from huffman_jax.ops.ils import IlsSection
    from huffman_jax.core.ils_ref import IlsParams
    from dataclasses import replace

    k = 8
    data = generate_redundant(k * ILS_LANES, 0.5, seed=22)
    table = _fit(data)
    enc, dec = ils_enc_tabs(table), ils_dec_tabs(table)
    avg = float(table.lengths.astype(np.int64)[data].mean())
    sec = ils_encode_device(data, table, enc, k=k, avg_bits=avg)
    bad = IlsSection(
        params=replace(sec.params, w_band=sec.params.w_cap // 2 + 1),
        payload=sec.payload,
    )
    with pytest.raises(ValueError, match="w_band"):
        ils_decode_device(bad, table, dec)


def test_lane_skewed_adversarial_roundtrip():
    # Half the streams of a tile all-zeros (shortest codes), half uniform
    # random (longest codes): the widest cross-lane schedule spread a tile
    # can see.  The oracle decoder raises if any refill leaves the band, so
    # a clean round-trip certifies the band actually covers the envelope.
    k = 256
    rng = np.random.default_rng(23)
    n = k * ILS_LANES
    u32 = np.zeros(n // 4, np.uint32)
    idx = np.arange(n // 4)
    randmask = (idx % ILS_LANES) >= 512
    u32[randmask] = rng.integers(
        0, 1 << 32, size=int(randmask.sum()), dtype=np.uint32
    )
    data = np.frombuffer(u32.astype("<u4").tobytes(), np.uint8)
    table = _fit(data)
    payload, params = ils_encode_np(data, table, k)
    assert 1 <= params.w_band <= params.w_cap // 2
    out = ils_decode_np(payload, params, table)
    assert np.array_equal(out, data)
