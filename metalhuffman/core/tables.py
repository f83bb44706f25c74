"""Decode lookup-table construction (NumPy).

Two layouts, mirroring the reference:

- **Single table**: 65536 entries indexed by a 16-bit left-justified window
  (reference: ``HuffmanUtil.cpp:314-334``). Each active symbol covers the
  contiguous index range ``[code_lj, code_lj + 2^(16-w))`` — built here as one
  vectorized repeat instead of the reference's per-suffix enumeration loop
  (``HuffmanUtil.cpp:116-265``).

- **Split two-level table** (T1 = ``k1`` bits, T2 = ``k2`` bits, k1+k2=16;
  reference: ``HuffmanUtil.cpp:338-667``): T1 entries for codes of width <= k1;
  longer codes grouped by their k1-bit high prefix into fixed-size secondary
  tables laid out as a slab, with **slot 0 reserved** (all-zero table) so a
  decoder may read T2 unconditionally (``:550-556``). A T1 escape entry has
  ``width == 0`` and ``symbol`` = secondary-table index (``:631-646``);
  secondary tables are ordered by ascending high prefix (``:562``), and T2
  entries store the symbol's *full* code width.

Entries are returned as separate ``symbol`` and ``width`` planes (uint8 /
int32-friendly) rather than the reference's interleaved
``HuffLookupSymbol {uint8 symbol; uint8 bitWidth;}`` POD — dense planes are
plain device arrays. ``pack_entries`` produces the fused
``width * 256 + symbol`` encoding used by the kernels (fits in 12 bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .canonical import canonical_codes

NUM_SYMBOLS = 256


def build_single_table(widths: np.ndarray):
    """Full 16-bit lookup table: returns (symbol[65536] u8, width[65536] u8)."""
    widths = np.asarray(widths, dtype=np.uint8)
    codes = canonical_codes(widths)
    sym_plane = np.zeros(1 << 16, dtype=np.uint8)
    w_plane = np.zeros(1 << 16, dtype=np.uint8)
    active = np.nonzero(widths)[0]
    for s in active:
        w = int(widths[s])
        start = int(codes[s])
        span = 1 << (16 - w)
        sym_plane[start : start + span] = s
        w_plane[start : start + span] = w
    return sym_plane, w_plane


@dataclass(frozen=True)
class SplitTables:
    """Two-level decode tables, slab layout identical to the reference."""

    t1_symbol: np.ndarray  # (2^k1,) uint8: symbol, or T2 table index if escape
    t1_width: np.ndarray  # (2^k1,) uint8: code width; 0 marks an escape entry
    t2_symbol: np.ndarray  # (num_tables * 2^k2,) uint8
    t2_width: np.ndarray  # (num_tables * 2^k2,) uint8 (full code width)
    k1: int
    k2: int

    @property
    def num_t2_tables(self) -> int:
        return self.t2_symbol.size >> self.k2


def build_split_tables(widths: np.ndarray, k1: int = 8, k2: int = 8) -> SplitTables:
    """Two-level (k1, k2) lookup tables; see module docstring for layout."""
    if k1 + k2 != 16:
        raise ValueError("k1 + k2 must equal 16 (16-bit decode window)")
    widths = np.asarray(widths, dtype=np.uint8)
    codes = canonical_codes(widths)
    n1 = 1 << k1
    n2 = 1 << k2

    t1_sym = np.zeros(n1, dtype=np.uint8)
    t1_w = np.zeros(n1, dtype=np.uint8)
    active = np.nonzero(widths)[0]

    # Short codes (width <= k1) fill T1 over their k1-bit prefix completions.
    for s in active:
        w = int(widths[s])
        if w <= k1:
            start = int(codes[s]) >> k2
            span = 1 << (k1 - w)
            t1_sym[start : start + span] = s
            t1_w[start : start + span] = w

    # Long codes grouped by their k1-bit high prefix, ascending prefix order.
    long_syms = [int(s) for s in active if int(widths[s]) > k1]
    prefixes = sorted({int(codes[s]) >> k2 for s in long_syms})
    prefix_to_table = {p: i + 1 for i, p in enumerate(prefixes)}  # slot 0 reserved

    num_tables = len(prefixes) + 1
    if num_tables > 256:
        # cannot happen for a complete prefix code (at least one code has
        # width <= k1 by Kraft), but guard malformed width tables: the T1
        # escape entry stores the table index in a uint8 symbol slot
        raise ValueError("too many escape prefixes for uint8 table indices")
    t2_sym = np.zeros(num_tables * n2, dtype=np.uint8)
    t2_w = np.zeros(num_tables * n2, dtype=np.uint8)

    for s in long_syms:
        w = int(widths[s])
        code = int(codes[s])
        table_idx = prefix_to_table[code >> k2]
        low = code & (n2 - 1)
        span = 1 << (16 - w)
        base = table_idx * n2
        t2_sym[base + low : base + low + span] = s
        t2_w[base + low : base + low + span] = w

    for p, t in prefix_to_table.items():
        if t1_w[p] != 0:
            raise AssertionError("escape prefix collides with a short code")
        t1_sym[p] = t

    return SplitTables(t1_sym, t1_w, t2_sym, t2_w, k1, k2)


def pack_entries(symbol: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Fuse (symbol, width) planes into int32 ``width * 256 + symbol`` (<= 12 bits)."""
    return (width.astype(np.int32) << 8) | symbol.astype(np.int32)


def unpack_entry(packed):
    """Inverse of :func:`pack_entries` — works on scalars or arrays."""
    return packed & 0xFF, packed >> 8
