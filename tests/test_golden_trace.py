"""Golden per-symbol trace: LITERAL hand-computed expected values.

The reference commits hand-computed per-symbol golden data — blocki/
rootBitOffset/currentBitOffset/bitWidth/bitPattern for its 6x4 config
(``HuffRenderFrame.m:235-318``). The differential fuzz tests
(test_debug_fuzz.py) compare ``trace_block`` against the decoder, but a
systematic offset-bookkeeping bug that fooled both sides would pass; the
literal table below pins the bit-level bookkeeping to values derived BY
HAND from the documented format rules, independent of any code in the repo.

Derivation (all by hand):

The 8x8 test image is the cumulative mod-256 sum of a chosen delta-symbol
sequence, so after block split + per-block delta precoding the encoder sees
exactly this 64-symbol multiset::

    counts: 0 -> 32, 1 -> 16, 2 -> 8, 3 -> 4, 255 -> 4

Huffman tree (every merge is forced — the two smallest weights are unique
as a SET at every step, so ANY correct Huffman implementation yields these
depths): merge(4,4)=8, merge(8,8)=16, merge(16,16)=32, merge(32,32)=root
=> widths 0:1, 1:2, 2:3, 3:4, 255:4.

Canonical assignment (sort by (width, symbol), sequential codes with a
left shift per width increase — ``huff_util.hpp:94-193`` semantics)::

    0 -> '0'    1 -> '10'    2 -> '110'    3 -> '1110'    255 -> '1111'

The delta sequence starts [3, 255, 2, 1, 0, 0, 1, 2, 255, 3, 1, 0]; widths
are [4,4,3,2,1,1,2,3,4,4,2,1], so the MSB-first bit offsets are the running
sum [0,4,8,11,13,14,15,17,20,24,28,30]. Total stream: 31 bits + 29x'0' +
13x'10' + 6x'110' + 2x'1110' + 2x'1111' = 120 bits = exactly 15 bytes,
packed MSB-first: EF D1 6F E8 00 00 00 0A AA AA AB 6D B6 EE FF.
"""

import numpy as np

from metalhuffman.models import CodecConfig, ImageCodec
from metalhuffman.utils import debug

# the hand-chosen delta-symbol sequence (counts 0:32, 1:16, 2:8, 3:4, 255:4)
DELTAS = ([3, 255, 2, 1, 0, 0, 1, 2, 255, 3, 1, 0]
          + [0] * 29 + [1] * 13 + [2] * 6 + [3] * 2 + [255] * 2)

# literal golden per-symbol records for the first 12 symbols:
# (index, bit_offset, width, pattern, symbol, reconstructed value)
GOLDEN = [
    (0, 0, 4, "1110", 3, 3),
    (1, 4, 4, "1111", 255, 2),       # (3 + 255) & 0xFF
    (2, 8, 3, "110", 2, 4),
    (3, 11, 2, "10", 1, 5),
    (4, 13, 1, "0", 0, 5),
    (5, 14, 1, "0", 0, 5),
    (6, 15, 2, "10", 1, 6),
    (7, 17, 3, "110", 2, 8),
    (8, 20, 4, "1111", 255, 7),
    (9, 24, 4, "1110", 3, 10),
    (10, 28, 2, "10", 1, 11),
    (11, 30, 1, "0", 0, 11),
]

GOLDEN_CODE_BYTES = bytes([
    0xEF, 0xD1, 0x6F, 0xE8, 0x00, 0x00, 0x00, 0x0A,
    0xAA, 0xAA, 0xAB, 0x6D, 0xB6, 0xEE, 0xFF,
])


def _image():
    """8x8 uint8 image whose per-block delta stream is exactly DELTAS."""
    return np.cumsum(np.array(DELTAS, np.uint8), dtype=np.uint8).reshape(8, 8)


def test_golden_canonical_table():
    codec = ImageCodec(CodecConfig(backend="native", delta=True))
    stream = codec.encode(_image())
    widths = np.zeros(256, np.uint8)
    widths[[0, 1, 2, 3, 255]] = [1, 2, 3, 4, 4]
    np.testing.assert_array_equal(stream.widths, widths)
    # canonical code patterns, straight from the hand assignment
    from metalhuffman.core import canonical

    codes = canonical.canonical_codes(stream.widths)
    expect = {0: "0", 1: "10", 2: "110", 3: "1110", 255: "1111"}
    for sym, pat in expect.items():
        assert debug.code_bits_as_string(
            int(codes[sym]), int(stream.widths[sym])) == pat


def test_golden_packed_stream():
    codec = ImageCodec(CodecConfig(backend="native", delta=True))
    stream = codec.encode(_image())
    assert stream.block_offsets.tolist() == [0]
    # 120 bits = 15 bytes exactly, + the decoder read-ahead pad
    from metalhuffman.core import bitstream

    assert stream.code_bytes.size == 15 + bitstream.READ_AHEAD_PAD_BYTES
    assert bytes(stream.code_bytes[:15]) == GOLDEN_CODE_BYTES
    assert bytes(stream.code_bytes[15:]) == bytes(
        bitstream.READ_AHEAD_PAD_BYTES)


def test_golden_trace_block():
    codec = ImageCodec(CodecConfig(backend="native", delta=True))
    img = _image()
    stream = codec.encode(img)
    trace = debug.trace_block(stream, 0, delta=True)
    assert len(trace) == 64
    for idx, off, w, pat, sym, val in GOLDEN:
        t = trace[idx]
        assert (t.index, t.bit_offset, t.width, t.pattern, t.symbol,
                t.value) == (idx, off, w, pat, sym, val), t
    # the remainder: offsets keep accumulating widths to the 120-bit end
    assert trace[-1].bit_offset + trace[-1].width == 120
    # reconstruction must equal the image raster
    assert [t.value for t in trace] == img.reshape(-1).tolist()
    # and the real decoders agree with the hand table end to end
    np.testing.assert_array_equal(codec.decode(stream, 8, 8), img)
