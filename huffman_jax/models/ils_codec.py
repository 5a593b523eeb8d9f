"""IlsCodec — the flagship interleaved-stream codec pipeline.

The successor to the gap-array design (see `core/ils_ref.py` for the layout,
`ops/ils.py` for the device orchestration and `ops/pallas/ils_kernels.py`
for the GPU kernels).  Relationship
to the reference (`Huffman_coding_Gap_arrays/`): both make data-parallel
decode possible with encoder-side metadata, but where the reference stores
a 4-bit entry offset per 128-bit segment and still needs a counting pass +
prefix sum + atomicOr scatter at decode time
(`decoder/src/decoder.cu:529-729`), ILS certifies a whole refill *schedule*
so the decoder is one fully static lock-step kernel whose output is the
original data by construction.

The stream is cut into a main section (uniform ``k`` symbols per stream,
chosen by `ops/ils.py::pick_k` for the table's mean code length) plus at most
one tail section with a smaller ``k``; the tail is zero-padded to a whole
tile (at most 4 KB of padding symbols).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import MAX_CODEWORD_LENGTH
from ..core import npref
from ..core.canonical import CodeTable, canonical_code_table
from ..core.ils_ref import ILS_LANES
from ..core.package_merge import package_merge_lengths
from ..ops.ils import (
    IlsSection,
    IlsVmemError,
    ils_decode_device,
    ils_encode_device,
    pick_k,
)
from ..ops.ils_xla import ils_dec_tabs, ils_enc_tabs

__all__ = ["IlsCompressed", "IlsCodec"]



@dataclasses.dataclass
class IlsCompressed:
    """Host-side compressed representation: table + 1-2 ILS sections."""

    table: CodeTable
    original_size: int
    sections: list  # list[IlsSection]

    @property
    def compressed_bytes(self) -> int:
        from ..io.container import ils_container_size

        return ils_container_size(self)


class IlsCodec:
    """Canonical length-limited Huffman codec over interleaved streams.

    Typical use::

        codec = IlsCodec.fit(data)     # host: histogram + tables + k choice
        comp = codec.encode(data)      # device: certified pack + row gather
        out = codec.decode(comp)       # device: one decode pass
    """

    #: max bytes encoded per device dispatch batch; files larger than this
    #: split into multiple sections so inputs beyond HBM capacity stream
    #: through (the container already carries a section list)
    SECTION_BYTES = 1 << 30

    def __init__(self, table: CodeTable, *, k: int | None = None,
                 optimize: str = "speed", rotate: bool | str = "auto"):
        self.table = table
        self.enc = ils_enc_tabs(table)
        self.dec = ils_dec_tabs(table)
        self.k = int(k) if k else pick_k(8.0, optimize)
        # lane-decorrelation rotation (container v4): "auto" (the default)
        # decides per section from the measured schedule envelope, turning
        # rotation on only when it narrows the certified band (content
        # periodic in the 4 KB lane stride; see `ops/ils.py::auto_rot_band`).
        # Decode always follows the container.
        self.rotate = rotate if rotate == "auto" else bool(rotate)

    # ------------------------------------------------------------------
    @classmethod
    def fit(
        cls,
        data: np.ndarray,
        *,
        max_len: int = MAX_CODEWORD_LENGTH,
        k: int | None = None,
        optimize: str = "speed",
        rotate: bool | str = "auto",
    ) -> "IlsCodec":
        data = np.asarray(data, np.uint8)
        freqs = npref.histogram(data)
        # account for the zero padding encode() appends (worst case one tile)
        freqs[0] += 1
        table = canonical_code_table(package_merge_lengths(freqs, max_len), max_len)
        avg = float(
            (freqs * table.lengths.astype(np.int64)).sum() / max(freqs.sum(), 1)
        )
        if k is None:
            k = pick_k(avg, optimize)
        codec = cls(table, k=k, rotate=rotate)
        # cached mean code length over the fitted data — saves callers a
        # second O(n) host histogram (`_avg_bits`) when encoding that data
        codec.fit_avg_bits = avg
        return codec

    # ------------------------------------------------------------------
    def _avg_bits(self, data: np.ndarray) -> float:
        freqs = npref.histogram(data)
        return float(
            (freqs * self.table.lengths.astype(np.int64)).sum() / max(data.size, 1)
        )

    def encode(self, data: np.ndarray) -> IlsCompressed:
        # A file whose longest stream far exceeds the table's mean code
        # length can exceed the row budget at the chosen k; halve k and
        # re-chunk until it fits (MIN_K always fits).
        from ..ops import ils as ils_ops

        k = self.k
        while True:
            try:
                return self._encode_with_k(data, k)
            except IlsVmemError:
                if k <= ils_ops.MIN_K:
                    raise
                k //= 2

    def _encode_with_k(self, data: np.ndarray, k_main: int) -> IlsCompressed:
        data = np.asarray(data, np.uint8)
        n = data.size
        comp = IlsCompressed(table=self.table, original_size=n, sections=[])
        if n == 0:
            return comp

        tile_bytes = k_main * ILS_LANES
        n_full = n // tile_bytes
        sections = []
        if n_full:
            sec_tiles = max(self.SECTION_BYTES // tile_bytes, 1)
            for lo in range(0, n_full, sec_tiles):
                hi = min(lo + sec_tiles, n_full)
                sections.append(
                    (data[lo * tile_bytes : hi * tile_bytes], k_main)
                )
        rem = n - n_full * tile_bytes
        if rem:
            k_tail = max(-(-rem // (4 * ILS_LANES)) * 4, 8)
            padded = np.zeros(k_tail * ILS_LANES, np.uint8)
            padded[:rem] = data[n_full * tile_bytes :]
            sections.append((padded, k_tail))

        for chunk, k in sections:
            comp.sections.append(
                ils_encode_device(
                    chunk,
                    self.table,
                    self.enc,
                    k=k,
                    avg_bits=self._avg_bits(chunk),
                    rot=self.rotate,
                )
            )
        return comp

    def decode(self, comp: IlsCompressed) -> np.ndarray:
        n = comp.original_size
        if n == 0:
            return np.zeros(0, np.uint8)
        outs = [
            ils_decode_device(sec, comp.table, self.dec)
            for sec in comp.sections
        ]
        return np.concatenate(outs)[:n]

    # ------------------------------------------------------------------
    # Section-streamed file paths: encode/decode a file
    # larger than one jit's working set with bounded host memory — at most
    # one section's bytes are resident at a time, and container sections
    # append/stream through `io.container.IlsStreamWriter/Reader`.
    # ------------------------------------------------------------------
    @classmethod
    def fit_file(
        cls,
        path: str,
        *,
        max_len: int = MAX_CODEWORD_LENGTH,
        chunk_bytes: int = 1 << 28,
        **kw,
    ) -> "IlsCodec":
        """`fit` from a file's streamed histogram (never loads the file)."""
        freqs = np.zeros(256, np.int64)
        n = 0
        with open(path, "rb") as f:
            while True:
                chunk = np.fromfile(f, np.uint8, chunk_bytes)
                if chunk.size == 0:
                    break
                freqs += np.bincount(chunk, minlength=256)
                n += chunk.size
        freqs[0] += 1  # the tail section's zero padding (as in `fit`)
        table = canonical_code_table(
            package_merge_lengths(freqs, max_len), max_len
        )
        avg = float(
            (freqs * table.lengths.astype(np.int64)).sum() / max(n, 1)
        )
        if kw.get("k") is None:
            kw = dict(kw, k=pick_k(avg, kw.get("optimize", "speed")))
        kw.pop("optimize", None)
        codec = cls(table, **kw)
        codec.fit_avg_bits = avg
        return codec

    def encode_file(
        self,
        in_path: str,
        out_path: str,
        *,
        section_bytes: int | None = None,
    ) -> int:
        """Streamed encode: read section-size chunks, pack each on device,
        append to the container.  Returns the container byte size."""
        import os

        from ..io.container import IlsStreamWriter
        from ..ops import ils as ils_ops

        section_bytes = section_bytes or self.SECTION_BYTES
        n = os.path.getsize(in_path)
        k = self.k
        with open(in_path, "rb") as fin, open(out_path, "w+b") as fout:
            writer = IlsStreamWriter(fout, self.table, n)
            pos = 0
            while pos < n:
                tile_bytes = k * ILS_LANES
                take = min(
                    max(section_bytes // tile_bytes, 1) * tile_bytes, n - pos
                )
                chunk = np.fromfile(fin, np.uint8, take)
                assert chunk.size == take
                if take % tile_bytes:
                    k_sec = max(-(-take // (4 * ILS_LANES)) * 4, 8)
                    padded = np.zeros(k_sec * ILS_LANES, np.uint8)
                    padded[:take] = chunk
                    chunk = padded
                else:
                    k_sec = k
                while True:
                    try:
                        sec = ils_encode_device(
                            chunk,
                            self.table,
                            self.enc,
                            k=k_sec,
                            avg_bits=self._avg_bits(chunk),
                            rot=self.rotate,
                        )
                        break
                    except IlsVmemError:
                        if k_sec <= ils_ops.MIN_K:
                            raise
                        k_sec //= 2  # take is still a multiple of k_sec*1024
                writer.write_section(sec)
                pos += take
            writer.close()
            return fout.tell()

    @classmethod
    def decode_file(cls, in_path: str, out_path: str) -> int:
        """Streamed decode of an ILS1 container to a file; returns the
        decoded byte count.  The payload CRC accumulates across sections
        and any mismatch raises AFTER the last write (streaming cannot
        front-run verification; callers needing all-or-nothing semantics
        should write to a temp path)."""
        from ..io.container import IlsStreamReader

        with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
            reader = IlsStreamReader(fin)
            codec = cls(reader.table)
            remaining = int(reader.original_size)
            while True:
                sec = reader.read_section()
                if sec is None:
                    break
                out = ils_decode_device(sec, reader.table, codec.dec)
                take = min(out.size, remaining)
                fout.write(out[:take].tobytes())
                remaining -= take
            reader.close()
            if remaining:
                raise ValueError(
                    f"container sections cover {remaining} bytes short of "
                    "original_size"
                )
            return int(reader.original_size)

    # ------------------------------------------------------------------
    def roundtrip_check(self, data: np.ndarray) -> bool:
        """Self-verifying round-trip (the reference's universal test pattern,
        `sequential.cpp:266-277`, `CUHDUtil::equals`)."""
        out = self.decode(self.encode(data))
        return bool(np.array_equal(out, np.asarray(data, np.uint8)))
