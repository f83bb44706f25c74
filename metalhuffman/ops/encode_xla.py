"""Device-side (XLA) canonical Huffman bit packing.

The reference encodes on the CPU only, bit-by-bit (``HuffmanEncoder.cpp:
211-276``). This is the device encode path: given the canonical table
(built on host — the tree algorithm is inherently serial and tiny), the
*packing* of millions of symbols becomes three data-parallel primitives:

    1. per-symbol width/code gather,
    2. an exclusive prefix-sum of widths -> every symbol's bit offset
       (this also yields the per-block offset index for free),
    3. a sorted segment-sum scatter of each symbol's left-justified code
       into its one or two overlapping big-endian u32 words. Canonical
       codes are zero-padded to the right, and offsets never overlap, so
       ADD == OR and the scatter is exact.

The output is the packed big-endian word stream the decode kernel reads, so
a device encode can feed a device decode without touching the host.

Both the width-gather and the code-gather index a 256-entry table with
byte values — plain XLA gathers, no kernel needed. The native C++ encoder
remains the production encoder; this module is the correctness-equivalent
on-device capability (useful when the payload already lives in device
memory and a host round-trip is worse). Its rate on the GPU is not
measured.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitstream, canonical
from ..core.container import EncodedStream


@partial(jax.jit, static_argnames=("block_size", "pad_words"))
def pack_bits_device(symbols, codes_lj, widths, *, block_size: int = 64,
                     pad_words: int = 2):
    """Pack a symbol stream into big-endian u32 words on device.

    Args:
        symbols: (n,) uint8 symbol stream (n multiple of block_size for a
            complete offset index; trailing partial block gets no offset).
        codes_lj: (256,) uint16 left-justified canonical codes.
        widths: (256,) uint8 code bit widths.

    Returns:
        (words, block_offsets, total_bits):
        words is (n // 2 + pad_words,) uint32 — worst-case capacity (16
        bits/symbol); valid words are ``ceil(total_bits / 32)``.
    """
    n = symbols.shape[0]
    sym = symbols.astype(jnp.int32)
    wd = widths.astype(jnp.int32)[sym]
    ends = jnp.cumsum(wd)
    offs = ends - wd  # exclusive prefix sum: bit offset of every symbol
    total_bits = ends[-1]

    code32 = (codes_lj.astype(jnp.uint32)[sym]) << 16  # left-justified in 32
    s = (offs & 31).astype(jnp.uint32)
    j = offs >> 5
    hi = code32 >> s
    # low spill into word j+1; (<<1 <<(31-s)) avoids the undefined <<32 at s=0
    lo = (code32 << 1) << (31 - s)

    num_words = n // 2 + pad_words  # worst case: 16 bits per symbol
    words = jax.ops.segment_sum(
        hi, j, num_segments=num_words, indices_are_sorted=True
    ) + jax.ops.segment_sum(
        lo, j + 1, num_segments=num_words, indices_are_sorted=True
    )
    block_offsets = offs[:: block_size][: n // block_size]
    return words.astype(jnp.uint32), block_offsets.astype(jnp.uint32), total_bits


def encode_symbols_device(symbols: np.ndarray, block_size: int = 64,
                          widths: np.ndarray | None = None) -> EncodedStream:
    """Full encode with device bit packing -> reference-format EncodedStream.

    The canonical table comes from the host (tree build on 256 counts is
    microseconds); frequency counting and packing run on device. Output is
    bit-identical to ``core.encode.encode_symbols`` / the native encoder.
    """
    symbols = np.asarray(symbols, dtype=np.uint8).ravel()
    if symbols.size == 0:
        raise ValueError("empty input")
    d_sym = jnp.asarray(symbols)
    if widths is None:
        freqs = np.asarray(jnp.bincount(d_sym.astype(jnp.int32), length=256))
        widths = canonical.huffman_code_lengths(freqs.astype(np.int64))
    codes = canonical.canonical_codes(widths)

    words, block_offs, total_bits = pack_bits_device(
        d_sym, jnp.asarray(codes), jnp.asarray(widths), block_size=block_size
    )
    total_bits = int(total_bits)
    n_bytes = (total_bits + 7) // 8

    # big-endian words -> byte stream, trimmed + 2 read-ahead pad bytes
    n_words = (n_bytes + 3) // 4
    wb = np.asarray(words[:n_words]).astype(">u4").view(np.uint8)
    code_bytes = np.zeros(n_bytes + bitstream.READ_AHEAD_PAD_BYTES, np.uint8)
    code_bytes[:n_bytes] = wb[:n_bytes]
    return EncodedStream(
        num_symbols=symbols.size,
        widths=np.asarray(widths, dtype=np.uint8),
        code_bytes=code_bytes,
        block_offsets=np.asarray(block_offs),
    )
