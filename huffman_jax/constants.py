"""Global constants for the Huffman codec.

These mirror the *roles* of the reference's compile-time configuration
(`gpuhd/include/cuhd_constants.h:15-24` and
`Huffman_coding_Gap_arrays/*/include/constants.hpp:4-40`):

- ``MAX_CODEWORD_LENGTH = 16`` matches the Yamamoto gap-array codec
  (`Huffman_coding_Gap_arrays/encoder/include/constants.hpp:5`). Length-limited
  codes keep every gap element in [0, 15] so it fits in 4 bits.
- ``UNIT_BITS = 32``: the bitstream is packed MSB-first into uint32 "units",
  the same unit type as the reference (`cuhd_constants.h`, ``UNIT_TYPE``).
- ``SEG_BITS = 1024``: our native segment size.  The reference uses 128-bit
  segments with a 4-bit gap each (3.125% metadata overhead); we use larger
  segments carrying (gap: 4 bits, symbol count: 12 bits) = 16 bits per
  segment (1.56% overhead) which both *shrinks* the compressed stream versus
  the reference and removes the decoder's counting pass entirely (the symbol
  count per segment is known at decode time, so output placement is a single
  ``cumsum`` instead of the reference's decode-count-scan-redecode pipeline,
  `decoder/src/decoder.cu:529-653`).
- ``REF_SEG_BITS = 128`` is kept for the reference-compatible container
  (4-bit gap only, two-pass decode).
"""

MAX_CODEWORD_LENGTH = 16
UNIT_BITS = 32
SEG_BITS = 1024
REF_SEG_BITS = 128
GAP_BITS = 4  # bits per gap element (max_len <= 16 keeps gaps in [0, 15])
COUNT_BITS = 12  # bits per segment symbol count; SEG_BITS <= 4096 fits

# Default uncompressed block size (bytes). Blocks are encoded fully
# independently (own gap metadata, shared code table), which is what makes the
# multi-chip path correct by construction: the reference's naive multi-GPU
# split at arbitrary unit boundaries broke codeword alignment
# (`gpuhd/multigpu_demo.cc:186-204`, README "TESTS FAIL"); block-aligned
# splitting at *encode* time is the fix its prescan demo was groping toward
# (`gpuhd-multigpu/multigpu_demo_prescan.cc:276-319`).
DEFAULT_BLOCK_BYTES = 1 << 24  # 16 MiB

# Bit-offset arithmetic inside one block uses int32; keep blocks small enough
# that block_bytes * MAX_CODEWORD_LENGTH < 2**31.
MAX_BLOCK_BYTES = 1 << 27

ALPHABET_SIZE = 256
