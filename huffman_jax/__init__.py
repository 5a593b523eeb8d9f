"""huffman_jax — a parallel Huffman codec framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the CUDA
reference (dek226/CSE375-FinalProj-Huffman-Decoding): canonical
length-limited Huffman coding with host-side package-merge table
construction (NumPy or native C++), massively data-parallel encode and
decode on the GPU (Pallas kernels compiled through Triton) via the
interleaved-stream (ILS) layout and gap-array segment metadata, a
metadata-free self-synchronizing decoder, byte-exact interop with the
reference's container formats, and multi-device/multi-host scaling over
`jax.sharding` meshes.  `backend.py` chooses between the GPU kernels and
their plain XLA versions on the CPU.

Heavy submodules (models, ops, parallel — which import jax) load lazily so
that host-only table math stays importable in minimal environments.
"""

__version__ = "0.1.0"

import importlib

from .core import (
    CodeTable,
    canonical_code_table,
    package_merge_lengths,
    huffman_lengths_unbounded,
    build_flat_lut,
    build_two_level_table,
)
from . import constants

__all__ = [
    "CodeTable",
    "canonical_code_table",
    "package_merge_lengths",
    "huffman_lengths_unbounded",
    "build_flat_lut",
    "build_two_level_table",
    "constants",
    "IlsCodec",
    "GapArrayCodec",
    "models",
    "ops",
    "io",
    "parallel",
    "utils",
    "native",
]

_LAZY = {
    "IlsCodec": ("huffman_jax.models", "IlsCodec"),
    "GapArrayCodec": ("huffman_jax.models", "GapArrayCodec"),
    "models": ("huffman_jax.models", None),
    "ops": ("huffman_jax.ops", None),
    "io": ("huffman_jax.io", None),
    "parallel": ("huffman_jax.parallel", None),
    "utils": ("huffman_jax.utils", None),
    "native": ("huffman_jax.native", None),
}


def __getattr__(name):
    if name in _LAZY:
        mod_name, attr = _LAZY[name]
        mod = importlib.import_module(mod_name)
        return getattr(mod, attr) if attr else mod
    raise AttributeError(f"module 'huffman_jax' has no attribute {name!r}")
