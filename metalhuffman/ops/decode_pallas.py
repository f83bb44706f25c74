"""Huffman block decode kernel for NVIDIA Hopper: Pallas, Triton route.

The reference decodes with one GPU thread per 8x8 block, a serial
64-symbol loop and a two-level 8/8-bit lookup table (``AAPLShaders.metal
:127-178``, tables ``HuffmanUtil.cpp:338-667``). This kernel keeps that
design and collapses the reference's five chained passes
(``AAPLRenderer.m:1192-1569``) into one:

- **One lane per block.** A program owns ``BLOCK_LANES`` consecutive
  blocks; each lane walks its block's bits serially. The grid covers the
  block axis; programs share nothing.
- **The packed stream is read in place.** Each lane starts at its block's
  bit offset in the big-endian u32 word stream and keeps a 64-bit window
  ``(w0, w1)`` in registers. The next word is fetched every symbol,
  independently of the decode chain, and taken when the window crosses a
  word boundary. No per-block rows are staged.
- **The decode table is data.** The reference's split tables
  (``decode_xla.prepare_tables``) are kernel operands, so one compiled
  kernel serves every canonical table.
- **Predictors in registers.** The 1-D delta is a running byte sum; delta2d
  (row 0 delta-left, later rows delta-up) keeps the previous block row's
  packed words in registers. Zero-init roots fold after the kernel.
- **Direct emission.** Every 4 decoded bytes form one little-endian int32
  word. With ``grid_bw`` the word is stored at its final position in an
  image of ``grid_bw`` blocks per row (frames stack as extra rows), so the
  kernel output is the image as int32 words; a byte view on the host is
  free. Without it (block_dim 2, or callers that want blocks), blocks come
  back in stream order as ``(n_blocks, block_size // 4)`` words.
- **End bits.** With ``emit_end_bits`` each lane also stores its final
  row-local bit position; comparing it with the offset index flags corrupt
  blocks (:func:`check_block_ends`), the device analog of the reference's
  decode-verify assert (``AAPLRenderer.m:1849-1876``).

On a CPU-only host the same kernel runs in Pallas interpret mode
(:func:`interpret_mode`); no other platform is accepted.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import bitstream

#: blocks decoded by one program (one lane each); a power of two
BLOCK_LANES = 128
#: warps per program (Triton CompilerParams)
NUM_WARPS = 4


def interpret_mode(platform: str | None = None) -> bool:
    """The one dispatch rule for every Pallas call in this package.

    ``"gpu"`` compiles the kernel; ``"cpu"`` runs it in the Pallas
    interpreter (tests, CPU-only hosts); any other platform is an error.
    """
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"the decode kernel runs compiled on 'gpu' or interpreted on 'cpu'; "
        f"JAX platform {platform!r} is not supported")


def raw_words_ok(block_dim: int) -> bool:
    """Whether a geometry decodes straight to image words (4 px a word)."""
    return block_dim % 4 == 0


def padded_geometry(height: int, width: int, block_dim: int = 8):
    """(rows per frame, pixels per row) of the kernel's image emission:
    the frame rounded up to whole blocks (cropped by the consumer)."""
    return (-(-height // block_dim) * block_dim,
            -(-width // block_dim) * block_dim)


def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


def _make_kernel(*, n_blocks: int, n_words: int, block_dim: int, delta: bool,
                 delta2d: bool, grid_bw: int, emit_end: bool, k1: int,
                 k2: int):
    num_steps = block_dim * block_dim
    n_out = num_steps // 4  # output words per block
    gpr = block_dim // 4  # words per block row (delta2d, image emission)
    lo_mask = (1 << k2) - 1

    def kernel(offs_ref, words_ref, t1_ref, t2_ref, out_ref, *end_ref):
        b = (pl.program_id(0) * BLOCK_LANES
             + jnp.arange(BLOCK_LANES, dtype=jnp.int32))
        live = b < n_blocks
        off = offs_ref[b]
        wi0 = _srl(off, 5)
        wi = wi0
        s = off & 31
        w0 = words_ref[jnp.minimum(wi, n_words - 1)]
        w1 = words_ref[jnp.minimum(wi + 1, n_words - 1)]
        if grid_bw:
            row_words = grid_bw * gpr
            # lax.div/rem: operands are non-negative, so truncating
            # division is floor division (and lowers to plain Triton ops)
            base = (jax.lax.div(b, grid_bw) * (block_dim * row_words)
                    + jax.lax.rem(b, grid_bw) * gpr)
        else:
            base = b * n_out
        # padding lanes point past the output: masked on the GPU, dropped by
        # the interpreter's scatter (an in-range index could race a live lane)
        base = jnp.where(live, base, n_blocks * n_out)

        def symbol(state):
            wi, s, w0, w1 = state
            # the next word does not depend on this symbol: fetch it first
            nxt = words_ref[jnp.minimum(wi + 2, n_words - 1)]
            win = jax.lax.shift_left(w0, s) | _srl(_srl(w1, 1), 31 - s)
            e1 = t1_ref[_srl(win, 32 - k1)]
            esc = _srl(e1, 8) == 0
            lo = _srl(win, 32 - k1 - k2) & lo_mask
            t2_idx = jax.lax.shift_left(e1 & 0xFF, k2) | lo
            e2 = t2_ref[jnp.where(esc, t2_idx, 0)]
            e = jnp.where(esc, e2, e1)
            s = s + _srl(e, 8)
            cross = s >= 32
            state = (wi + cross.astype(jnp.int32), s & 31,
                     jnp.where(cross, w1, w0), jnp.where(cross, nxt, w1))
            return state, e & 0xFF

        def body(j, carry):
            state, prev, hist = carry
            word = jnp.zeros_like(prev)
            for i in range(4):
                state, sym = symbol(state)
                if delta2d:
                    # row 0 is the 1-D running sum; later rows add the byte
                    # above, held in the word gpr outputs back
                    above = _srl(hist[0], 8 * i) & 0xFF
                    pred = jnp.where(j < gpr, prev, above)
                    prev = (pred + sym) & 0xFF
                    out = prev
                elif delta:
                    prev = (prev + sym) & 0xFF
                    out = prev
                else:
                    out = sym
                word = word | jax.lax.shift_left(out, 8 * i)
            if grid_bw:
                idx = (base + jax.lax.div(j, gpr) * row_words
                       + jax.lax.rem(j, gpr))
            else:
                idx = base + j
            plgpu.store(out_ref.at[idx], word, mask=live)
            if delta2d:
                hist = hist[1:] + (word,)
            return state, prev, hist

        zero = jnp.zeros((BLOCK_LANES,), jnp.int32)
        hist = (zero,) * gpr if delta2d else ()
        (wi, s, _, _), _, _ = jax.lax.fori_loop(
            0, n_out, body, ((wi, s, w0, w1), zero, hist))
        if emit_end:
            plgpu.store(end_ref[0].at[jnp.where(live, b, n_blocks)],
                        jax.lax.shift_left(wi - wi0, 5) + s, mask=live)

    return kernel


@partial(jax.jit, static_argnames=(
    "block_dim", "delta", "delta2d", "grid_bw", "emit_end_bits", "k1", "k2"))
def decode(words, offsets, t1, t2, *, block_dim: int = 8, delta: bool = True,
           delta2d: bool = False, grid_bw: int = 0,
           emit_end_bits: bool = False, k1: int = 8, k2: int = 8):
    """Decode every block of a stream with the Hopper kernel.

    Args:
        words: (n_words,) big-endian u32 code words (int32 or uint32),
            with at least 2 pad words past the last code bit.
        offsets: (n_blocks,) block bit offsets (u32 values; int32 or
            uint32), in output order.
        t1, t2: packed split decode tables (``decode_xla.prepare_tables``).
        block_dim: block edge (2, 4, 8, 16): ``block_dim**2`` symbols each.
        delta / delta2d: in-register predictor (delta2d needs
            ``block_dim % 4 == 0``; pass delta=False with it).
        grid_bw: > 0 emits image words for a grid of ``grid_bw`` blocks a
            row (``n_blocks % grid_bw == 0``, ``block_dim % 4 == 0``);
            0 emits blocks in order.
        emit_end_bits: also return each block's final row-local bit
            position ((n_blocks,) int32).

    Returns:
        ``(n_blocks // grid_bw * block_dim, grid_bw * block_dim // 4)``
        int32 image words, or ``(n_blocks, block_dim**2 // 4)`` int32 block
        words; each word holds 4 decoded bytes little-endian. With
        ``emit_end_bits`` a ``(words, end_bits)`` tuple.
    """
    num_steps = block_dim * block_dim
    if num_steps % 4:
        raise ValueError(f"block_dim {block_dim} is not supported")
    if delta2d and (delta or not raw_words_ok(block_dim)):
        raise ValueError("in-kernel delta2d needs delta=False and "
                         "block_dim % 4 == 0")
    n_blocks = offsets.shape[0]
    if grid_bw:
        if not raw_words_ok(block_dim) or n_blocks % grid_bw:
            raise ValueError(
                f"image emission needs block_dim % 4 == 0 and whole block "
                f"rows (n_blocks={n_blocks}, grid_bw={grid_bw})")
        out_shape = (n_blocks // grid_bw * block_dim,
                     grid_bw * block_dim // 4)
    else:
        out_shape = (n_blocks, num_steps // 4)
    n_prog = max(1, -(-n_blocks // BLOCK_LANES))
    offs = jax.lax.bitcast_convert_type(
        jnp.asarray(offsets).astype(jnp.uint32), jnp.int32)
    offs = jnp.pad(offs, (0, n_prog * BLOCK_LANES - n_blocks))
    words = jax.lax.bitcast_convert_type(
        jnp.asarray(words).astype(jnp.uint32), jnp.int32)
    n_out_words = out_shape[0] * out_shape[1]
    shapes = [jax.ShapeDtypeStruct((n_out_words,), jnp.int32)]
    if emit_end_bits:
        shapes.append(jax.ShapeDtypeStruct((n_blocks,), jnp.int32))
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    res = pl.pallas_call(
        _make_kernel(n_blocks=n_blocks, n_words=words.shape[0],
                     block_dim=block_dim, delta=delta, delta2d=delta2d,
                     grid_bw=grid_bw, emit_end=emit_end_bits, k1=k1, k2=k2),
        grid=(n_prog,),
        in_specs=[anywhere] * 4,
        out_specs=[anywhere] * len(shapes),
        out_shape=shapes,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret_mode(),
        name="huffman_decode",
    )(offs, words, t1.astype(jnp.int32), t2.astype(jnp.int32))
    out = res[0].reshape(out_shape)
    return (out, res[1]) if emit_end_bits else out


def blocks_from_words(out, num_steps: int = 64):
    """(n_blocks, num_steps//4) int32 block words -> (n_blocks, num_steps)
    uint8 (little-endian byte view)."""
    return jax.lax.bitcast_convert_type(out, jnp.uint8).reshape(
        out.shape[0], num_steps)


def images_from_words(out, num_frames: int, height: int, width: int,
                      block_dim: int = 8):
    """Image words -> (T, H, W) uint8: byte view plus the block-pad crop."""
    rows_pf, w_pad = padded_geometry(height, width, block_dim)
    img = jax.lax.bitcast_convert_type(out, jnp.uint8).reshape(
        num_frames, rows_pf, w_pad)
    if (rows_pf, w_pad) == (height, width):
        return img
    return img[:, :height, :width]


def prepare_stream(stream, k1: int = 8, k2: int = 8):
    """Host staging: (words, offsets, t1, t2) arrays for :func:`decode`."""
    from .decode_xla import prepare_tables

    t1, t2 = prepare_tables(stream.widths, k1, k2)
    words = bitstream.bytes_to_be_words(stream.code_bytes, pad_words=2)
    return words, np.asarray(stream.block_offsets, np.uint32), t1, t2


def decode_stream_pallas(stream, *, delta: bool = True, block_size: int = 64):
    """Full decode of an EncodedStream -> (n_blocks, block_size) uint8."""
    words, offsets, t1, t2 = prepare_stream(stream)
    bd = int(round(block_size ** 0.5))
    out = decode(jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(t1),
                 jnp.asarray(t2), block_dim=bd, delta=delta)
    return blocks_from_words(out, block_size)


# -- on-device stream-integrity check -----------------------------------------
#
# A canonical Huffman stream self-synchronizes only if every bit is intact:
# any flipped/lost bit desyncs the decoder, and the block then ends at the
# wrong bit position with overwhelming probability. The kernel's loop carry
# already holds each block's final row-local bit position — emitting it
# (``emit_end_bits``) and comparing against ``init + block_bits`` (known from
# the offset index) yields a per-block corruption mask with no extra decode
# work. This is the device analog of the reference's decode-verify assert
# (``AAPLRenderer.m:1849-1876``), but O(blocks) instead of O(pixels), and it
# runs on the production path rather than a separate verification decode.
# (A corruption that preserves total bit length within a block — e.g. two
# compensating symbol swaps — passes this check; pair it with the container
# CRC for whole-payload integrity.)

def block_end_targets(block_offsets, last_end_bit: int | None) -> np.ndarray:
    """Stream-order expected row-local end bit per block -> (nb,) int32.

    ``last_end_bit`` is the bit position where the LAST block ends (equal to
    the stream's exact total bits when there is no partial tail). Pass None
    when unknown (e.g. the stream may carry tail symbols past the last
    whole block): the last block is then marked -1 = unchecked.
    """
    offs = np.asarray(block_offsets, dtype=np.int64)
    if offs.size == 0:
        return np.zeros(0, np.int32)
    if last_end_bit is None:
        ends = np.append(offs[1:], offs[-1])  # placeholder, masked below
    else:
        ends = np.append(offs[1:], np.int64(last_end_bit))
    t = ((offs & 31) + (ends - offs)).astype(np.int32)
    if last_end_bit is None:
        t[-1] = -1
    return t


def last_block_window(stream, block_size: int):
    """Byte-rounded ``(lo, hi)`` window for the last block's end bit, or
    None when the stream carries tail symbols past its last whole block.

    The offset index does not record where the last block ends; without a
    tail it ends at the stream's exact bit count, known only up to the
    encoder's byte rounding.
    """
    nb = stream.block_offsets.size
    if not nb or stream.num_symbols != nb * block_size:
        return None
    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    last = int(stream.block_offsets[-1])
    hi = (last & 31) + (total_bits - last)
    return hi - 7, hi


def check_block_ends(end_bits, targets, last_window=None) -> np.ndarray:
    """Kernel end bits vs targets (-1 = don't check) -> (nb,) bool err mask,
    both in stream order; ``last_window`` checks the last block."""
    e = np.asarray(end_bits).reshape(-1)
    t = np.asarray(targets).reshape(-1)
    err = (e != t) & (t >= 0)
    if last_window is not None and err.size:
        lo, hi = last_window
        err[-1] = not lo <= int(e[-1]) <= hi
    return err


def decode_stream_checked(stream, *, delta: bool = True, block_size: int = 64):
    """Decode + integrity-check an EncodedStream on-device.

    Returns (blocks (nb, block_size) uint8, err_mask (nb,) bool). A True
    mask entry means that block did not end at its indexed bit position —
    the stream is corrupt or truncated there.
    """
    words, offsets, t1, t2 = prepare_stream(stream)
    bd = int(round(block_size ** 0.5))
    out, end = decode(jnp.asarray(words), jnp.asarray(offsets),
                      jnp.asarray(t1), jnp.asarray(t2), block_dim=bd,
                      delta=delta, emit_end_bits=True)
    err = check_block_ends(end, block_end_targets(offsets, None),
                           last_block_window(stream, block_size))
    return blocks_from_words(out, block_size), err
