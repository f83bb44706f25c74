"""Packed bitstream -> per-block padded word-row layout.

The wire stream stays packed (compressed-size parity with the reference); the
plain-XLA decoder (``ops.decode_xla``) first re-stages it as one aligned
u32-word row per block so that its symbol loop gathers from a 2-D array by
(block, word) (the +2-byte read-ahead pad of ``HuffmanEncoder.cpp:371-378``
generalizes to one extra word here). The decode kernel reads the packed
stream in place and needs none of this.

Row ``b`` holds ``words_per_block`` big-endian u32 words starting at word
``block_offsets[b] >> 5`` of the stream; the block's first code bit is bit
``block_offsets[b] & 31`` of its row. The row count is static per compiled
shape, so it is bucketed to limit recompiles across frames.
"""

from __future__ import annotations

import numpy as np

#: Row-size buckets (in u32 words). 34 covers the worst case for 64 symbols
#: of <= 16 bits each: the last refill group starts at bit <= 31 + 60*16 so
#: needs words up to ((31 + 960) >> 5) + 2 = 32 -> 33 words. Larger blocks
#: (block_dim > 8) extend past the table in multiples of 8 words.
WORD_BUCKETS = (6, 10, 14, 18, 26, 34)
MAX_WORDS_PER_BLOCK = WORD_BUCKETS[-1]


def words_per_block(max_block_bits: int, symbols_per_block: int = 64) -> int:
    """Smallest row bucket safely covering ``max_block_bits``.

    Sizing covers a 3-word refill fetch at each 4-symbol group (more than
    ``decode_xla``'s 2-word window needs): the final group starts at bit
    ``init + consumed`` where ``init <= 31`` and ``consumed`` (bits decoded
    before that group) is bounded both by the block's own size minus at
    least 1 bit per remaining symbol AND by ``S-4`` codes of <= 16 bits.
    The fetch reads words ``wi, wi+1, wi+2`` so the row must extend to
    ``wi + 2`` inclusive — i.e. ``((31 + consumed) >> 5) + 3`` words. (The
    previous ``+2`` sizing let ``wi`` reach ``width - 2`` on bucket-edge
    streams, silently zeroing the refill for the last groups.)
    """
    mbb = int(max_block_bits)
    group = 4  # decode_pallas.SYMS_PER_GROUP
    consumed = max(0, min(mbb - group, (int(symbols_per_block) - group) * 16))
    need = ((31 + consumed) >> 5) + 3
    for b in WORD_BUCKETS:
        if b >= need:
            return b
    # beyond the bucket table (large blocks): round up to a multiple of 8
    return -(-need // 8) * 8


def max_block_bits(block_offsets: np.ndarray, total_bits: int) -> int:
    """Largest encoded block size in bits (offsets are ascending)."""
    offs = np.asarray(block_offsets, dtype=np.int64)
    if offs.size == 0:
        return 0
    ends = np.append(offs[1:], np.int64(total_bits))
    return int((ends - offs).max())


def build_layout_np(code_words_be: np.ndarray, block_offsets: np.ndarray, width: int):
    """NumPy layout: returns (rows (nblocks, width) uint32, bit_init (nblocks,) int32)."""
    words = np.asarray(code_words_be, dtype=np.uint32)
    offs = np.asarray(block_offsets, dtype=np.int64)
    word_start = offs >> 5
    idx = word_start[:, None] + np.arange(width, dtype=np.int64)[None, :]
    # Pad the word stream so every row index is in range.
    pad_to = int(idx.max(initial=0)) + 1
    if pad_to > words.size:
        words = np.concatenate([words, np.zeros(pad_to - words.size, np.uint32)])
    rows = words[idx]
    bit_init = (offs & 31).astype(np.int32)
    return rows, bit_init


def build_layout_jax(code_words_be, block_offsets, width: int):
    """JAX layout (device-side gather): same contract as :func:`build_layout_np`.

    ``code_words_be`` must already include enough trailing pad words
    (``bitstream.bytes_to_be_words(..., pad_words=width)`` guarantees it).
    """
    import jax.numpy as jnp

    offs = block_offsets.astype(jnp.int32)
    word_start = offs >> 5
    idx = word_start[:, None] + jnp.arange(width, dtype=jnp.int32)[None, :]
    rows = jnp.take(code_words_be, idx, mode="clip")
    return rows, (offs & 31).astype(jnp.int32)
