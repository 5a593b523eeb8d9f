"""Binary interop against the COMPILED reference sequential codec.

The north-star correctness claim is bit-exactness *versus the reference
implementation itself*, not just our own NumPy oracle.  This module
compiles the reference's `sequential.cpp` (read-only, never copied) behind
a thin file-I/O driver (`native/ref_seq_driver.cpp`) and exposes
encode/decode through it, so tests can round-trip real 100 MB blobs both
directions:

- reference encode -> our `decode_seq`         (foreign greedy-tree codes)
- our `write_seq`  -> reference decode         (canonical codes, same format)

Reference anchor: `sequential.cpp:163-204` (format), `:236-277` (its own
in-memory round-trip main, which this driver replaces with file modes).
Everything degrades to skip when the reference tree or g++ is missing.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

__all__ = ["ref_seq_source", "ref_available", "build_ref_driver",
           "ref_encode", "ref_decode"]

_REPO = pathlib.Path(__file__).resolve().parents[2]
_DRIVER_SRC = _REPO / "native" / "ref_seq_driver.cpp"


def ref_seq_source() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get("HUFFMAN_REF_SEQ", "/root/reference/sequential.cpp")
    )


def ref_available() -> bool:
    import shutil

    return (
        ref_seq_source().is_file()
        and _DRIVER_SRC.is_file()
        and shutil.which(os.environ.get("CXX", "g++")) is not None
    )


def build_ref_driver() -> pathlib.Path:
    """Compile (once, cached by source hashes) and return the driver path."""
    src = ref_seq_source()
    key = hashlib.sha256(
        src.read_bytes() + _DRIVER_SRC.read_bytes()
    ).hexdigest()[:16]
    cache = pathlib.Path(tempfile.gettempdir()) / f"huffman_jax_refseq_{key}"
    exe = cache / "ref_seq"
    if exe.is_file():
        return exe
    cache.mkdir(parents=True, exist_ok=True)
    # private tmp name + atomic rename: concurrent builders (xdist workers)
    # never see each other's partial output
    fd, tmp = tempfile.mkstemp(prefix="ref_seq.", dir=cache)
    os.close(fd)
    try:
        subprocess.run(
            [
                os.environ.get("CXX", "g++"), "-O2", "-std=c++17",
                f'-DREF_SEQ_SOURCE="{src}"',
                str(_DRIVER_SRC), "-o", tmp,
            ],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, exe)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return exe


def _run(mode: str, blob: bytes) -> bytes:
    exe = build_ref_driver()
    with tempfile.TemporaryDirectory() as d:
        fin = pathlib.Path(d) / "in.bin"
        fout = pathlib.Path(d) / "out.bin"
        fin.write_bytes(blob)
        subprocess.run(
            [str(exe), mode, str(fin), str(fout)],
            check=True, capture_output=True, text=True,
        )
        return fout.read_bytes()


def ref_encode(data: np.ndarray) -> bytes:
    """Reference `HuffmanSequential::encode` over raw bytes."""
    return _run("encode", np.asarray(data, np.uint8).tobytes())


def ref_decode(blob: bytes) -> np.ndarray:
    """Reference `HuffmanSequential::decode` over a sequential-format blob."""
    return np.frombuffer(_run("decode", blob), np.uint8)
