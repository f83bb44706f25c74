"""Vectorized Huffman block decode in pure jnp (XLA), one lane per block.

This is the plain-XLA decode path (``backend="xla"``): it runs wherever XLA
does, is the device oracle for the decode kernel, and the function
``shard_map`` shards across devices. On the H100 it runs about 11-14x
slower than the kernel end to end (PERF.md) — use it for
correctness and CPU meshes; ``ops.decode_pallas`` is the throughput path.

The algorithm replaces the reference's per-fragment serial decode
(``AAPLShaders.metal:127-178, 291-445``) with a 64-step loop where *every* step
decodes one symbol in *every* block simultaneously:

  window assembly   3-byte fetch + shift (Metal :137-155)  ->  two-word funnel
                                                               shift on u32 rows
  T1/T2 lookup      buffer loads (Metal :159-170)          ->  jnp.take gathers,
                                                               branchless escape
  delta reconstruct prevSymbol accumulate (Metal :260-265) ->  running u32 add
  carry state       4th color attachment between passes    ->  loop carry in
                    (AAPLRenderer.m:1192-1569)                 registers; the 5
                                                               render passes
                                                               collapse into one
                                                               fused loop

Tables are passed in the packed ``width*256 + symbol`` int32 form
(:mod:`metalhuffman.core.tables`); T1 escape entries have width 0 and
symbol = secondary-table index, T2 slab slot 0 is reserved/zero, exactly the
reference's layout (``HuffmanUtil.cpp:338-667``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitstream, tables as tables_mod
from . import layout as layout_mod


def _u32(x):
    return x.astype(jnp.uint32)


@partial(jax.jit, static_argnames=("num_steps", "delta", "k2",
                                   "emit_end_bits"))
def decode_blocks(rows, bit_init, t1_packed, t2_packed, *, num_steps: int = 64,
                  delta: bool = True, k2: int = 8,
                  emit_end_bits: bool = False):
    """Decode ``num_steps`` symbols from every block row.

    Args:
        rows: (nblocks, W) uint32 big-endian word rows (see ops.layout).
        bit_init: (nblocks,) int32 starting bit within each row (0..31).
        t1_packed: (2^k1,) int32 packed primary table.
        t2_packed: (num_tables * 2^k2,) int32 packed secondary slab.
        num_steps: symbols per block (block_dim**2).
        delta: apply in-loop running-sum delta reconstruction.
        k2: low-window bit count of the split tables.
        emit_end_bits: also return each block's final row-local bit position
            ((nblocks,) int32) — the loop carry the integrity check compares
            against the offset index (``decode_pallas.block_end_targets``).

    Returns:
        (nblocks, num_steps) uint8 decoded symbols; with ``emit_end_bits``
        a (symbols, end_bits) tuple.
    """
    nblocks = rows.shape[0]
    rows = _u32(rows)
    lane_idx = jnp.arange(nblocks, dtype=jnp.int32)

    def step(state, _):
        bits, prev = state
        wi = (bits >> 5).astype(jnp.int32)
        w0 = rows[lane_idx, wi]
        w1 = rows[lane_idx, wi + 1]
        s = _u32(bits & 31)
        # Left-justified 32-bit window; (w1 >> 1) >> (31-s) avoids the
        # undefined >>32 when s == 0.
        hi32 = (w0 << s) | ((w1 >> 1) >> (31 - s))
        pat1 = (hi32 >> jnp.uint32(16 + k2)).astype(jnp.int32)
        e1 = t1_packed[pat1]
        esc = (e1 >> 8) == 0
        lo = ((hi32 >> 16).astype(jnp.int32)) & ((1 << k2) - 1)
        t2_idx = jnp.where(esc, ((e1 & 0xFF) << k2) | lo, 0)
        e2 = t2_packed[t2_idx]
        e = jnp.where(esc, e2, e1)
        sym = (e & 0xFF).astype(jnp.uint32)
        width = (e >> 8).astype(jnp.int32)
        if delta:
            prev = (prev + sym) & jnp.uint32(0xFF)
            out = prev
        else:
            out = sym
        return (bits + width, prev), out.astype(jnp.uint8)

    # prev derives from bit_init (not a fresh zeros) so its varying-axis type
    # matches the loop output when this function runs inside shard_map.
    init = (bit_init.astype(jnp.int32), (bit_init * 0).astype(jnp.uint32))
    (end_bits, _), out = jax.lax.scan(step, init, None, length=num_steps)
    if emit_end_bits:
        return out.T, end_bits
    return out.T  # (nblocks, num_steps)


def prepare_tables(widths: np.ndarray, k1: int = 8, k2: int = 8,
                   num_tables_bucket: int = 32):
    """Host-side: packed (t1, t2) int32 arrays, T2 padded to a bucket size."""
    st = tables_mod.build_split_tables(widths, k1, k2)
    t1 = tables_mod.pack_entries(st.t1_symbol, st.t1_width)
    t2 = tables_mod.pack_entries(st.t2_symbol, st.t2_width)
    n2 = 1 << k2
    nt = st.num_t2_tables
    bucket = num_tables_bucket
    while bucket < nt:
        bucket *= 2
    t2 = np.concatenate([t2, np.zeros((bucket - nt) * n2, np.int32)])
    return t1.astype(np.int32), t2.astype(np.int32)


def prepare_stream(stream, width: int | None = None):
    """Host-side: (code_words_be, block_offsets, width) for the device layout."""
    if width is None:
        total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
        width = layout_mod.words_per_block(
            layout_mod.max_block_bits(stream.block_offsets, total_bits)
        )
    words = bitstream.bytes_to_be_words(stream.code_bytes, pad_words=width)
    return words, stream.block_offsets.astype(np.int32), width


def decode_stream(stream, *, delta: bool = True, block_size: int = 64):
    """Convenience: full host->device decode of an EncodedStream -> (nblocks, 64)."""
    t1, t2 = prepare_tables(stream.widths)
    words, offsets, width = prepare_stream(stream)
    rows, bit_init = layout_mod.build_layout_jax(
        jnp.asarray(words), jnp.asarray(offsets), width
    )
    return decode_blocks(
        rows, bit_init, jnp.asarray(t1), jnp.asarray(t2),
        num_steps=block_size, delta=delta,
    )
