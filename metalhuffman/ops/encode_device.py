"""Hybrid device/host canonical-Huffman encoder.

The inverse of the device decode, replacing the reference's single-threaded
host append loop (``HuffmanEncoder.cpp:211-276``) with a two-stage pipeline:

- **Stage 1 (device, plain XLA)**: every block packs its 64 symbols into a
  padded ``wmax``-word row in parallel (:func:`pack_rows`). Each 4-symbol
  group builds a 64-bit chunk from direct ``codes[sym]``/``widths[sym]``
  gathers and ORs it into the row's words with a select deposit — one
  elementwise program over the block axis, which XLA fuses.
- **Stage 2 (C++, host)**: ``native.merge_rows`` — a multithreaded
  bit-shift memcpy that concatenates the padded rows into the contiguous
  MSB-first stream, using the same head-byte OR seam trick as the
  multithreaded host encoder (``native/src/mht_codec.cpp::mht_encode_mt``).
  Per-block offsets fall out of a prefix sum over per-block bit counts.

The output stream is byte-identical to ``native.encode_symbols`` /
``core.encode.encode_symbols`` (differential tests in
tests/test_encode_pallas.py): same canonical table (built on host by the
same native/NumPy code), same MSB-first packing, same +2 read-ahead pad
(``HuffmanEncoder.cpp:371-378``), same per-block offsets
(``HuffmanUtil.cpp:1102-1117``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..core import bitstream
from ..core.container import EncodedStream

BLOCK_SYMBOLS = 64  # 8x8 blocks (16 groups of 4 symbols)


def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


@partial(jax.jit, static_argnames=("wmax", "min_w", "max_w"))
def pack_rows(symbols, codes, widths, *, wmax: int, min_w: int = 1,
              max_w: int = 16):
    """Stage 1: (n_blocks, 64) symbols -> (n_blocks, wmax+1) int32 rows.

    Words 0..wmax-1 of a row are the block's MSB-first packed bits (zero
    padded); word ``wmax`` is the block's total bit count.

    ``min_w``/``max_w`` are the canonical table's min/max USED symbol
    widths: group g's in-block bit offset t is bounded by
    ``[4g*min_w, 4g*max_w]``, so the deposit touches only words
    ``[t_lo>>5, (t_hi>>5)+2]`` instead of all wmax. Padding blocks may
    carry symbols outside the used-width band and deposit outside that
    window — their rows are garbage by contract and masked out of the
    merge, so correctness only needs real symbols' widths inside
    [min_w, max_w].
    """
    sym = symbols.astype(jnp.int32).T  # (64, n_blocks): one vector a symbol
    codes = codes.astype(jnp.int32)
    widths = widths.astype(jnp.int32)
    zero = jnp.zeros(sym.shape[1:], jnp.int32)
    words = [zero] * wmax
    t = zero  # in-block bit offset
    for g in range(BLOCK_SYMBOLS // 4):
        # build one 64-bit chunk (C0 hi word, C1 lo word) from 4 symbols
        c0 = c1 = n = zero  # n = bits in chunk
        for k in range(4):
            s = sym[4 * g + k]
            w = widths[s]
            # append the left-justified code at chunk bit offset n.
            # n + w <= 64 always (4 x 16-bit max), so nothing spills.
            c32 = jax.lax.shift_left(codes[s], 16)
            sh = n & 31
            hi_part = _srl(c32, sh)
            lo_part = jax.lax.shift_left(jax.lax.shift_left(c32, 1), 31 - sh)
            in_hi = n < 32
            c0 = c0 | jnp.where(in_hi, hi_part, 0)
            c1 = c1 | jnp.where(in_hi, lo_part, hi_part)
            n = n + w
        # deposit the chunk at in-block bit offset t: it spans at most
        # three of the row's words (t&31 misalignment + 64 bits)
        wi = _srl(t, 5)
        sh = t & 31
        d0 = _srl(c0, sh)
        mid = (jax.lax.shift_left(jax.lax.shift_left(c0, 1), 31 - sh)
               | _srl(c1, sh))
        d2 = jax.lax.shift_left(jax.lax.shift_left(c1, 1), 31 - sh)
        lo = (4 * g * min_w) >> 5
        hi = min(wmax - 1, ((4 * g * max_w) >> 5) + 2)
        for j in range(lo, hi + 1):
            words[j] = (words[j]
                        | jnp.where(wi == j, d0, 0)
                        | jnp.where(wi == j - 1, mid, 0)
                        | jnp.where(wi == j - 2, d2, 0))
        t = t + n
    return jnp.stack(words + [t], axis=1)


def used_width_band(widths: np.ndarray) -> tuple[int, int]:
    """(min, max) USED symbol width of a canonical table (width 0 =
    unused symbol). Static bounds for the kernel's ranged deposit."""
    used = np.asarray(widths)[np.asarray(widths) > 0]
    if used.size == 0:
        return 1, 16
    return int(used.min()), int(used.max())


def _append_tail_bits(code: np.ndarray, total_bits: int,
                      tail_packed: np.ndarray, tail_bits: int) -> np.ndarray:
    """Append a short packed bit run at ``total_bits`` (host, boundary-OR)."""
    lead = total_bits & 7
    out_bytes = (total_bits + tail_bits + 7) // 8 + 2  # +2 read-ahead pad
    out = np.zeros(out_bytes, dtype=np.uint8)
    n_full = (total_bits + 7) // 8
    out[:n_full] = code[:n_full]
    shifted = np.zeros(((lead + tail_bits + 7) // 8) * 8, dtype=np.uint8)
    shifted[lead:lead + tail_bits] = np.unpackbits(tail_packed)[:tail_bits]
    packed = np.packbits(shifted)
    base = total_bits >> 3
    out[base] |= packed[0]  # the only byte both runs may share
    out[base + 1: base + packed.size] = packed[1:]
    return out


def encode_symbols_hybrid(data: np.ndarray, block_size: int = 64,
                          n_threads: int = 0) -> EncodedStream:
    """Hybrid device/host encode -> EncodedStream (byte-identical to native).

    Stage 1 packs per-block word rows on the device; stage 2 merges them into
    the contiguous stream with the multithreaded C++ bit-memcpy. The
    canonical table is built on the host (256 frequencies — table build is
    microseconds and must match the native tie-breaking exactly).

    A partial tail block (``n % 64`` symbols) is packed on the host and
    bit-appended, mirroring ``core.encode.encode_symbols`` semantics: the
    offset index covers complete blocks only.
    """
    if block_size != BLOCK_SYMBOLS:
        raise ValueError(
            f"hybrid encoder supports block_size={BLOCK_SYMBOLS} only "
            "(stage 1 is specialized to 8x8 blocks); use native")
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")

    freqs = np.bincount(data, minlength=256).astype(np.int64)
    widths = native.code_lengths(freqs)
    codes = native.canonical_codes(widths)

    n_blocks = data.size // block_size
    if n_blocks == 0:  # nothing for the device to do
        return native.encode_symbols(data, block_size, n_threads)
    body = data[: n_blocks * block_size]

    # per-block bit counts (host): drives wmax, the merge, and the offsets
    bits_pb = (widths[body].reshape(n_blocks, block_size)
               .astype(np.uint32).sum(axis=1, dtype=np.uint32))
    if int(bits_pb.astype(np.int64).sum()) + 16 * (data.size % block_size) \
            >= 1 << 32:
        raise ValueError(
            "stream exceeds 2^32 bits — u32 block offsets overflow; "
            "split the input (e.g. per-frame or segmented MHTV)")
    wmax = int(bits_pb.max()) // 32 + 2  # ceil + 1 spare (merge bound check)
    min_w, max_w = used_width_band(widths)

    # stage 1 on device
    out = pack_rows(
        jax.device_put(body.reshape(n_blocks, block_size)),
        jnp.asarray(codes.astype(np.int32)),
        jnp.asarray(widths.astype(np.int32)),
        wmax=wmax, min_w=min_w, max_w=max_w)
    rows = np.asarray(out[:, :wmax]).view(np.uint32)

    # stage 2 on host: bit-shift memcpy merge + offsets prefix sum
    code, offsets, total_bits = native.merge_rows(rows, bits_pb, n_threads)

    tail = data[n_blocks * block_size:]
    if tail.size:
        tail_packed, tail_offs = bitstream.pack_bits(tail, codes, widths)
        code = _append_tail_bits(
            code, total_bits, tail_packed, int(tail_offs[-1]))
    return EncodedStream(
        num_symbols=data.size,
        widths=np.asarray(widths, dtype=np.uint8),
        code_bytes=np.ascontiguousarray(code),
        block_offsets=offsets,
    )
