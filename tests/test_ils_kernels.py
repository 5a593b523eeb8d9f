"""ILS Triton kernels (interpret mode) against the NumPy oracle and the plain
XLA versions, the kernels' CUDA lowering, and the backend decision.

The kernels and the XLA versions share their per-lane loop bodies
(`ops/ils_xla.py`); what differs is the memory access (per-block masked
loads and stores vs whole-array gathers and scatters), so both are pinned
bit-for-bit to `core/ils_ref.py`.  Compiling for the card happens only on
the GPU (``gpu`` marker, ``chip_smoke.py``); lowering to Triton IR is
checked here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from huffman_jax import backend
from huffman_jax.core import canonical_code_table, package_merge_lengths, npref
from huffman_jax.core.canonical import chain_spec
from huffman_jax.core.ils_ref import (
    ILS_LANES,
    ils_encode_np,
    ils_schedule_numer,
)
from huffman_jax.ops.ils import as_u32_rows, stride_rows_for
from huffman_jax.ops.ils_xla import (
    ils_compact,
    ils_dec_tabs,
    ils_decode_xla,
    ils_enc_tabs,
    ils_pack_certify_xla,
    rot_word,
)
from huffman_jax.ops.pallas.ils_kernels import (
    ils_decode_triton,
    ils_pack_certify_triton,
)


def _gen(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "single":  # one repeated symbol: a 1-bit code
        return np.full(n, 7, np.uint8)
    if kind == "one_bit":  # two symbols: 1-bit codes
        return rng.integers(0, 2, n).astype(np.uint8)
    if kind == "uniform8":  # 256 equally frequent symbols: 8-bit codes,
        # every codeword word-aligned
        return rng.permutation(np.resize(np.arange(256, dtype=np.uint8), n))
    if kind == "skew16":  # Fibonacci counts: an unbounded Huffman tree
        # deeper than 16, so package-merge clamps at 16
        fib = [1, 1]
        while len(fib) < 19:
            fib.append(fib[-1] + fib[-2])
        d = np.zeros(n, np.uint8)
        d[: sum(fib)] = np.repeat(np.arange(1, 20, dtype=np.uint8), fib)
        return rng.permutation(d)
    if kind == "blocky":  # zeros next to random, 4 KB blocks
        d = rng.integers(0, 256, n).astype(np.uint8)
        d.reshape(-1, 4096)[::2] = 0
        return d
    raise ValueError(kind)


def _table(data):
    return canonical_code_table(
        package_merge_lengths(npref.histogram(data), 16), 16
    )


def _pack_outputs(fn, data, table, k, rot):
    avg = float(table.lengths.astype(np.int64)[data].mean())
    stride = stride_rows_for(k, max(table.max_len_present, 1))
    return stride, fn(
        jnp.asarray(as_u32_rows(data)), jnp.int32(ils_schedule_numer(avg)),
        ils_enc_tabs(table), k=k, stride_rows=stride, rot=rot,
    )


_pack_interp = functools.partial(ils_pack_certify_triton, interpret=True)
_decode_interp = functools.partial(ils_decode_triton, interpret=True)


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("k", [8, 48, 2048])
@pytest.mark.parametrize(
    "kind", ["single", "one_bit", "uniform8", "skew16", "blocky"]
)
def test_triton_kernels_match_oracle_and_xla(kind, k, rot):
    n_tiles = 1 if k == 2048 else 2
    data = _gen(kind, n_tiles * k * ILS_LANES, seed=k)
    table = _table(data)
    want_max = {"single": 1, "one_bit": 1, "uniform8": 8, "skew16": 16}.get(kind)
    if want_max:
        assert table.max_len_present == want_max
    payload_np, p = ils_encode_np(data, table, k, rot=rot)

    stride, got = _pack_outputs(_pack_interp, data, table, k, rot)
    _, ref = _pack_outputs(ils_pack_certify_xla, data, table, k, rot)
    for name, a, b in zip(("bits", "dec_min", "dec_max"), got[1:], ref[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    starts = jnp.asarray(p.row_starts)
    for pay_s, bits in ((got[0], got[1]), (ref[0], ref[1])):
        rows = ils_compact(pay_s, bits, starts, stride_rows=stride,
                           total_rows=p.total_rows)
        assert np.array_equal(np.asarray(rows), payload_np)

    kw = dict(k=k, min_len=table.min_len, chain=chain_spec(table), rot=rot)
    out_t = np.asarray(_decode_interp(jnp.asarray(payload_np), starts,
                                      ils_dec_tabs(table), **kw))
    out_x = np.asarray(ils_decode_xla(jnp.asarray(payload_np), starts,
                                      ils_dec_tabs(table), **kw))
    assert np.array_equal(out_t.reshape(-1).view(np.uint8), data)
    assert np.array_equal(out_t, out_x)


@pytest.mark.parametrize("block,num_warps", [(64, 2), (256, 8)])
def test_triton_block_shape_does_not_change_output(block, num_warps):
    k = 48
    data = _gen("blocky", 2 * k * ILS_LANES, seed=3)
    table = _table(data)
    payload_np, p = ils_encode_np(data, table, k, rot=True)
    starts = jnp.asarray(p.row_starts)
    kw = dict(k=k, min_len=table.min_len, chain=chain_spec(table), rot=True)
    out = _decode_interp(jnp.asarray(payload_np), starts, ils_dec_tabs(table),
                         block=block, num_warps=num_warps, **kw)
    assert np.array_equal(np.asarray(out).reshape(-1).view(np.uint8), data)
    pack = functools.partial(_pack_interp, block=block, num_warps=num_warps)
    stride, got = _pack_outputs(pack, data, table, k, True)
    rows = ils_compact(got[0], got[1], starts, stride_rows=stride,
                       total_rows=p.total_rows)
    assert np.array_equal(np.asarray(rows), payload_np)


@pytest.mark.parametrize("rot", [False, True])
def test_decode_ignores_bits_past_each_stream(rot):
    # a stream's zero padding (words past its own length, up to the tile's
    # row count) is never consumed: the canonical length decode depends on
    # a codeword's own bits only.  This is why the decoder may load each
    # stream's next pair directly, with no certified band.
    from huffman_jax.core.ils_ref import ils_stream_symbols

    k = 48
    data = _gen("uniform8", 3 * k * ILS_LANES, seed=8)
    data.reshape(-1, ILS_LANES, 4)[:, :512] = 0  # short streams: padding
    table = _table(data)
    payload_np, p = ils_encode_np(data, table, k, rot=rot)
    lens = table.lengths[ils_stream_symbols(data, k, rot=rot)].astype(np.int64)
    words = 2 * (-(-lens.sum(axis=1) // 64))  # (n_tiles, lanes)
    noisy = payload_np.copy()
    rng = np.random.default_rng(1)
    for t in range(p.n_tiles):
        r = np.arange(p.w_tiles[t])[:, None]
        pad = r >= words[t][None]
        blk = noisy[p.row_starts[t] : p.row_starts[t + 1]]
        blk[pad] = rng.integers(0, 1 << 32, int(pad.sum()), np.uint32)
    assert not np.array_equal(noisy, payload_np)
    kw = dict(k=k, min_len=table.min_len, chain=chain_spec(table), rot=rot)
    for dec in (ils_decode_xla, _decode_interp):
        out = dec(jnp.asarray(noisy), jnp.asarray(p.row_starts),
                  ils_dec_tabs(table), **kw)
        assert np.array_equal(np.asarray(out).reshape(-1).view(np.uint8), data)


@pytest.mark.parametrize("r", [0, 3, 1000])
def test_rot_word_is_a_permutation_and_inverse(r):
    s = jnp.arange(ILS_LANES, dtype=jnp.int32)
    fwd = np.asarray(rot_word(s, r))
    inv = np.asarray(rot_word(s, r, +1))
    assert sorted(fwd.tolist()) == list(range(ILS_LANES))
    assert np.array_equal(inv[fwd], np.arange(ILS_LANES))


def test_compact_zeroes_rows_past_the_last_tile():
    rng = np.random.default_rng(5)
    stride, n_tiles = 8, 3
    pay_s = jnp.asarray(
        rng.integers(1, 1 << 32, (n_tiles * stride, ILS_LANES), np.uint32)
    )
    bits = jnp.asarray(rng.integers(0, 8 * 32, (n_tiles, ILS_LANES), np.int32))
    words = 2 * ((np.asarray(bits) + 63) // 64)
    w_tiles = np.maximum(words.max(axis=1), 4)
    starts = np.concatenate([[0], np.cumsum(w_tiles)]).astype(np.int32)
    total = int(starts[-1]) + 5
    out = np.asarray(ils_compact(pay_s, bits, jnp.asarray(starts),
                                 stride_rows=stride, total_rows=total))
    ps = np.asarray(pay_s)
    for t in range(n_tiles):
        for j in range(w_tiles[t]):
            row = out[starts[t] + j]
            want = np.where(j < words[t], ps[t * stride + j], 0)
            assert np.array_equal(row, want)
    assert not out[starts[-1]:].any()


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("which", ["decode", "pack"])
def test_kernels_lower_to_triton_for_cuda(which, rot):
    # lowering to Triton IR runs here; only compiling it needs the card
    from jax import export

    sds = jax.ShapeDtypeStruct
    k, n_tiles = 4096, 2
    if which == "decode":
        dec = ils_dec_tabs(_table(np.arange(256, dtype=np.uint8)))
        fn = functools.partial(ils_decode_triton, k=k, min_len=2,
                               chain=((3, 1), (5, 2), (9, 1)), rot=rot)
        args = (sds((n_tiles * 1500, ILS_LANES), jnp.uint32),
                sds((n_tiles + 1,), jnp.int32), dec)
    else:
        enc = ils_enc_tabs(_table(np.arange(256, dtype=np.uint8)))
        fn = functools.partial(ils_pack_certify_triton, k=k, stride_rows=2048,
                               rot=rot)
        args = (sds((n_tiles * k // 4, ILS_LANES), jnp.uint32),
                sds((), jnp.int32), enc)
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


def test_backend_cpu_uses_plain_versions():
    assert backend.platform() == "cpu"
    assert backend.use_kernels() is False


def test_backend_rejects_unknown_platform(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.use_kernels()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = backend.setup_compile_cache()
        assert path == backend.CACHE_DIR
        assert os.path.basename(path) == ".jax_cache"
        assert os.path.dirname(path) == os.path.dirname(
            os.path.dirname(os.path.abspath(backend.__file__))
        )
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
@pytest.mark.parametrize("rot", [False, True])
def test_compiled_kernels_match_xla(gpu, rot):
    k = 4096
    data = _gen("blocky", 4 * k * ILS_LANES, seed=9)
    table = _table(data)
    payload_np, p = ils_encode_np(data, table, k, rot=rot)
    starts = jnp.asarray(p.row_starts)
    kw = dict(k=k, min_len=table.min_len, chain=chain_spec(table), rot=rot)
    dec = ils_dec_tabs(table)
    out = ils_decode_triton(jnp.asarray(payload_np), starts, dec, **kw)
    assert np.array_equal(np.asarray(out).reshape(-1).view(np.uint8), data)
    stride, got = _pack_outputs(ils_pack_certify_triton, data, table, k, rot)
    rows = ils_compact(got[0], got[1], starts, stride_rows=stride,
                       total_rows=p.total_rows)
    assert np.array_equal(np.asarray(rows), payload_np)
