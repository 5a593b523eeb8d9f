"""ctypes bindings for the native host module (native/huffman_native.cpp).

The framework's host-side table math ships in two interchangeable
implementations: vectorized NumPy (always available) and this C++ module
(OpenMP histogram, coin-collector package-merge, canonical assignment,
MSB-first bit packer) — the counterpart of the reference's host C++ encoder
components (`llhuffman_encoder.cc`, `package_merge.cpp`,
`parallel_cpu.cpp:130-169`).  Both produce bit-identical outputs (enforced
by tests/test_native.py).

Build with ``make -C native`` (or let `_load` build it automatically on
first use — a fresh checkout has only the source); loading is lazy and
failure-tolerant — if the shared library is absent, cannot be built, or
``HUFFMAN_NO_NATIVE`` is set, callers fall back to NumPy.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

import numpy as np

__all__ = [
    "available",
    "histogram",
    "package_merge_lengths",
    "canonical_pieces",
    "encode_bits",
    "decode_prefix_lut",
]

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HUFFMAN_NO_NATIVE"):
        return None
    here = pathlib.Path(__file__).resolve().parent
    candidates = [
        here.parent / "native" / "libhuffman_native.so",  # repo checkout
        here / "libhuffman_native.so",  # copied next to the package
    ]
    # installed packages (site-packages) have no native/ sibling; let the
    # user point at a built .so explicitly
    env = os.environ.get("HUFFMAN_NATIVE")
    if env:
        candidates.insert(0, pathlib.Path(env))
    if not any(c.exists() for c in candidates):
        built = _build(here.parent / "native")
        if built is not None:
            candidates.insert(0, built)
    for c in candidates:
        if c.exists():
            try:
                lib = ctypes.CDLL(str(c))
            except OSError:
                continue
            lib.hn_histogram.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.hn_package_merge.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.hn_package_merge.restype = ctypes.c_int
            lib.hn_canonical.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int)]
            lib.hn_canonical.restype = ctypes.c_int
            lib.hn_encode_bits.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.hn_encode_bits.restype = ctypes.c_int64
            if not hasattr(lib, "hn_decode_prefix_lut"):
                continue  # stale .so from before v2; rebuild via make
            lib.hn_decode_prefix_lut.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64]
            lib.hn_decode_prefix_lut.restype = ctypes.c_int64
            _LIB = lib
            break
    return _LIB


def _build(native_dir: pathlib.Path) -> pathlib.Path | None:
    """Best-effort one-shot build of the shared library from a source-only
    checkout (the NumPy fallback is correct but ~30x slower on the host
    histogram, which dominates `fit` at GB scale)."""
    src = native_dir / "huffman_native.cpp"
    out = native_dir / "libhuffman_native.so"
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not src.exists() or cxx is None or not os.access(native_dir, os.W_OK):
        return None
    tmp = native_dir / f".libhuffman_native.{os.getpid()}.so"
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic vs concurrent builders
        return out
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None


def available() -> bool:
    return _load() is not None


def histogram(data: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    out = np.zeros(256, np.int64)
    lib.hn_histogram(data.ctypes.data, data.size, out.ctypes.data)
    return out


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    freqs = np.ascontiguousarray(freqs, np.int64)
    lengths = np.zeros(256, np.uint8)
    rc = lib.hn_package_merge(freqs.ctypes.data, max_len, lengths.ctypes.data)
    if rc != 0:
        raise ValueError(f"native package_merge failed (rc={rc})")
    return lengths


def canonical_pieces(lengths: np.ndarray):
    """Returns (codes (256,) uint32, symtab (n,) uint8)."""
    lib = _load()
    assert lib is not None
    lengths = np.ascontiguousarray(lengths, np.uint8)
    codes = np.zeros(256, np.uint32)
    symtab = np.zeros(256, np.uint8)
    n = ctypes.c_int(0)
    rc = lib.hn_canonical(
        lengths.ctypes.data, codes.ctypes.data, symtab.ctypes.data,
        ctypes.byref(n),
    )
    if rc != 0:
        raise ValueError("native canonical assignment failed (Kraft violation)")
    return codes, symtab[: n.value].copy()


def encode_bits(data: np.ndarray, codes: np.ndarray, lengths: np.ndarray):
    """MSB-first u32 pack; returns (words incl. one pad unit, total_bits)."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    codes = np.ascontiguousarray(codes, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    bound = int(lengths[data].astype(np.int64).sum()) if data.size else 0
    words = np.zeros(bound // 32 + 2, np.uint32)
    total = lib.hn_encode_bits(
        data.ctypes.data, data.size, codes.ctypes.data, lengths.ctypes.data,
        words.ctypes.data, words.size,
    )
    if total < 0:
        raise ValueError(f"native encode_bits failed (rc={total})")
    n_words = (int(total) + 31) // 32
    return words[: n_words + 1], int(total)


def decode_prefix_lut(
    payload: np.ndarray,
    total_bits: int,
    lut_sym: np.ndarray,
    lut_len: np.ndarray,
    lut_bits: int,
    out_cap: int,
) -> np.ndarray:
    """Sequential flat-LUT prefix-code walk over an MSB-first byte stream.

    Native-speed oracle for arbitrary (possibly non-canonical) prefix codes —
    the role of `sequential.cpp:88-94`'s bit-by-bit map loop, fast enough to
    cross-validate 100 MB blobs against the compiled reference binary.
    """
    lib = _load()
    assert lib is not None
    payload = np.ascontiguousarray(payload, np.uint8)
    lut_sym = np.ascontiguousarray(lut_sym, np.uint8)
    lut_len = np.ascontiguousarray(lut_len, np.uint8)
    assert lut_sym.size == lut_len.size == (1 << lut_bits)
    out = np.empty(out_cap, np.uint8)
    n = lib.hn_decode_prefix_lut(
        payload.ctypes.data, payload.size, total_bits,
        lut_sym.ctypes.data, lut_len.ctypes.data, lut_bits,
        out.ctypes.data, out.size,
    )
    if n < 0:
        raise ValueError(f"native prefix-LUT decode failed (rc={n})")
    return out[:n].copy()
