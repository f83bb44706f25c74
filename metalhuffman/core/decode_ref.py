"""Serial reference decoders (NumPy) — the correctness oracle.

Python analog of the reference's CPU decoders: the single-table variant
(``HuffmanUtil.cpp:673-823``) and the two-level split-table variant
(``HuffmanUtil.cpp:830-1046``). Every faster path (vectorized XLA decode,
the Pallas decode kernel, C++ native decoder) is tested bit-exact against
these.

Decode step (identical to ``AAPLShaders.metal:127-178``): fetch 3 bytes at
``bits >> 3``, assemble a left-justified 16-bit window by shifting out the
``bits & 7`` consumed bits, then either index the 64K table directly or do the
T1 lookup on the top k1 bits with a branch to T2 on a ``width == 0`` escape.
"""

from __future__ import annotations

import numpy as np

from .tables import SplitTables


def _window16(buf: np.ndarray, bits: int) -> int:
    byte_i = bits >> 3
    rem = bits & 7
    b0 = int(buf[byte_i])
    b1 = int(buf[byte_i + 1])
    b2 = int(buf[byte_i + 2])
    window24 = (b0 << 16) | (b1 << 8) | b2
    return (window24 >> (8 - rem)) & 0xFFFF


def decode_single_table(
    code_bytes: np.ndarray,
    sym_plane: np.ndarray,
    w_plane: np.ndarray,
    num_symbols: int,
    start_bit: int = 0,
) -> np.ndarray:
    """Serial decode via the full 16-bit table (``HuffmanUtil.cpp:673-823``)."""
    buf = np.asarray(code_bytes, dtype=np.uint8)
    out = np.empty(num_symbols, dtype=np.uint8)
    bits = start_bit
    for i in range(num_symbols):
        window = _window16(buf, bits)
        out[i] = sym_plane[window]
        w = int(w_plane[window])
        assert w > 0, "invalid code / corrupt stream"
        bits += w
    return out


def decode_split_tables(
    code_bytes: np.ndarray,
    tables: SplitTables,
    num_symbols: int,
    start_bit: int = 0,
) -> np.ndarray:
    """Serial decode via two-level tables (``HuffmanUtil.cpp:830-1046``)."""
    buf = np.asarray(code_bytes, dtype=np.uint8)
    out = np.empty(num_symbols, dtype=np.uint8)
    k2 = tables.k2
    low_mask = (1 << k2) - 1
    bits = start_bit
    for i in range(num_symbols):
        window = _window16(buf, bits)
        hi = window >> k2
        sym = int(tables.t1_symbol[hi])
        w = int(tables.t1_width[hi])
        if w == 0:  # escape: sym is the secondary-table index
            t2_idx = (sym << k2) | (window & low_mask)
            sym = int(tables.t2_symbol[t2_idx])
            w = int(tables.t2_width[t2_idx])
        assert w > 0, "invalid code / corrupt stream"
        out[i] = sym
        bits += w
    return out
