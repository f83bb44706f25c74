"""Per-block signed-byte delta precoding (NumPy, vectorized).

Reference semantics (``HuffmanUtil.cpp:21-85`` applied per 8x8 block at
``AAPLRenderer.m:432-515``): within each block the first byte is emitted
literally and every following byte is the wrapping difference from its
predecessor; reconstruction is a running sum mod 256 that restarts at each
block root (the GPU shader's ``prevSymbol`` accumulator,
``AAPLShaders.metal:260-265``).
"""

from __future__ import annotations

import numpy as np


def delta_encode_blocks(blocks: np.ndarray) -> np.ndarray:
    """Delta-encode along the last axis; shape (..., block_len) uint8."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    out = blocks.copy()
    out[..., 1:] = blocks[..., 1:] - blocks[..., :-1]  # uint8 wraps mod 256
    return out


def delta_decode_blocks(deltas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`delta_encode_blocks` (cumsum mod 256 per block)."""
    deltas = np.asarray(deltas, dtype=np.uint8)
    return np.cumsum(deltas, axis=-1, dtype=np.int64).astype(np.uint8)


def delta2d_encode_blocks(blocks: np.ndarray, block_dim: int) -> np.ndarray:
    """2-D within-block predictor: row 0 delta-left, rows 1.. delta-up.

    Beyond-reference capability (the reference's only precoder is the 1-D
    raster delta above, ``AAPLRenderer.m:432-515``). Residuals stay strictly
    inside the block, so block-parallel decode is preserved; on photographic
    content the vertical predictor beats the raster delta by ~3 entropy
    points (60.8% -> 58.0% of raw on the BigBridge asset — see PERF.md).
    Input/output shape (..., block_dim*block_dim) uint8.
    """
    b = np.asarray(blocks, dtype=np.uint8)
    sq = b.reshape(*b.shape[:-1], block_dim, block_dim)
    out = sq.copy()
    out[..., 0, 1:] = sq[..., 0, 1:] - sq[..., 0, :-1]  # row 0: delta-left
    out[..., 1:, :] = sq[..., 1:, :] - sq[..., :-1, :]  # rows 1..: delta-up
    return out.reshape(b.shape)


def delta2d_decode_blocks(res: np.ndarray, block_dim: int) -> np.ndarray:
    """Inverse of :func:`delta2d_encode_blocks`.

    Row 0 is a running sum along the row; every pixel is then a running sum
    down its column (both mod 256). The root byte res[0][0] propagates
    additively into every pixel, so the zero-init side-channel fold
    (:func:`apply_block_init`) composes unchanged.
    """
    r = np.asarray(res, dtype=np.uint8)
    sq = r.reshape(*r.shape[:-1], block_dim, block_dim).copy()
    # uint8 accumulate wraps mod 256 natively — no widening temp needed
    row0 = sq[..., 0, :]
    np.add.accumulate(row0, axis=-1, dtype=np.uint8, out=row0)
    np.add.accumulate(sq, axis=-2, dtype=np.uint8, out=sq)
    return sq.reshape(r.shape)


def _group_prefix_jax(x, axis: int, group: int):
    """Within-group prefix sums along ``axis`` (group boundaries at multiples
    of ``group``), as log2(group) masked shifted adds.

    uint8 adds wrap mod 256 natively. Shifts whose source crosses a group
    boundary are masked to zero, so truncated edge groups need no padding
    (a roll's wrap-around only reaches positions the mask kills). This
    lowering is all elementwise — XLA fuses it, where ``jnp.cumsum`` on a
    minor dim of 8 lowers to a scan with relayouts around it.
    """
    import jax.numpy as jnp

    n = x.shape[axis]
    pos = jnp.arange(n) % group
    shape = [1] * x.ndim
    shape[axis] = n
    s = 1
    while s < group:
        shifted = jnp.roll(x, s, axis)
        keep = (pos >= s).reshape(shape)
        x = x + jnp.where(keep, shifted, jnp.zeros_like(x))
        s *= 2
    return x


def delta2d_decode_frames_jax(frames, block_dim: int):
    """JAX inverse of the 2-D predictor on (..., H, W) residual frames.

    Row 0 of each block gets a prefix along W within the block (computed
    everywhere, selected onto block-row-0 rows); then every pixel a prefix
    down its column within the block. All mod 256 in uint8.
    """
    import jax.numpy as jnp

    x = frames.astype(jnp.uint8)
    h = x.shape[-2]
    rowsel = [1] * x.ndim
    rowsel[-2] = h
    is_row0 = ((jnp.arange(h) % block_dim) == 0).reshape(rowsel)
    x = jnp.where(is_row0, _group_prefix_jax(x, x.ndim - 1, block_dim), x)
    return _group_prefix_jax(x, x.ndim - 2, block_dim)


def delta2d_decode_blocks_jax(blk, block_dim: int):
    """JAX inverse of the 2-D predictor on (..., block_dim**2) blocks."""
    import jax.numpy as jnp

    sq = blk.reshape(*blk.shape[:-1], block_dim, block_dim)
    return delta2d_decode_frames_jax(sq, block_dim).reshape(
        blk.shape).astype(jnp.uint8)


def split_zero_init(deltas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-init-delta transform: (..., block_len) deltas -> (init, zeroed).

    The reference's ``IMPL_DELTAS_AND_INIT_ZERO_DELTA_BEFORE_HUFF_ENCODING``
    variant (``AAPLShaderTypes.h:110``, ``AAPLRenderer.m:449-473``): each
    block's first delta (its literal root byte) moves to a raw side array
    and the stream slot becomes 0 — boosting the zero-delta count so the
    canonical tree spends fewer bits on it; the root byte ships uncoded.
    """
    d = np.asarray(deltas, dtype=np.uint8).copy()
    init = d[..., 0].copy()
    d[..., 0] = 0
    return init, d


def apply_block_init(blocks: np.ndarray, init: np.ndarray) -> np.ndarray:
    """Fold init bytes back into zero-init-decoded blocks.

    Initializing the decoder's ``prev`` accumulator to the block's init
    byte (the reference seeds the render target's R channel with it,
    ``AAPLRenderer.m:1050-1068``) is equivalent to decoding with prev=0 and
    adding the init byte to every output byte of the block mod 256 — which
    keeps every decode kernel unchanged.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    return (blocks + np.asarray(init, dtype=np.uint8)[..., None]).astype(
        np.uint8)
