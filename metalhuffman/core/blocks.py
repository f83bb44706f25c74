"""Image <-> zero-padded block-order reordering (NumPy + JAX variants).

Reference: ``Util.m:233-323`` (``splitIntoBlocksOfSize:inBytes:``) reorders a
W x H byte image into 8x8 blocks in raster block order, zero-padding the right
and bottom edges; ``flattenBlocksOfSize`` (``Util.m:539-611``) is the inverse.
On the device this is just pad + reshape + transpose, fused by XLA — no custom
kernel is needed (SURVEY.md section 7 design translation).
"""

from __future__ import annotations

import numpy as np


def block_grid(height: int, width: int, block_dim: int = 8) -> tuple[int, int]:
    """Ceil-div block-grid geometry (reference: ``Util.m:616-632``)."""
    return (-(-height // block_dim), -(-width // block_dim))


def image_to_blocks(img: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """(H, W) image -> (num_blocks, block_dim**2) in raster block order."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    bh, bw = block_grid(h, w, block_dim)
    padded = np.zeros((bh * block_dim, bw * block_dim), dtype=np.uint8)
    padded[:h, :w] = img
    # (bh, block_dim, bw, block_dim) -> (bh, bw, block_dim, block_dim)
    tiles = padded.reshape(bh, block_dim, bw, block_dim).transpose(0, 2, 1, 3)
    return tiles.reshape(bh * bw, block_dim * block_dim)


def blocks_to_image(
    blocks: np.ndarray, height: int, width: int, block_dim: int = 8
) -> np.ndarray:
    """Inverse of :func:`image_to_blocks`, cropping the zero padding."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    bh, bw = block_grid(height, width, block_dim)
    tiles = blocks.reshape(bh, bw, block_dim, block_dim).transpose(0, 2, 1, 3)
    padded = tiles.reshape(bh * block_dim, bw * block_dim)
    return padded[:height, :width]


def image_to_blocks_jax(img, block_dim: int = 8):
    """JAX version of :func:`image_to_blocks` (traceable, static shapes)."""
    import jax.numpy as jnp

    h, w = img.shape
    bh, bw = block_grid(h, w, block_dim)
    padded = jnp.pad(img, ((0, bh * block_dim - h), (0, bw * block_dim - w)))
    tiles = padded.reshape(bh, block_dim, bw, block_dim).transpose(0, 2, 1, 3)
    return tiles.reshape(bh * bw, block_dim * block_dim)


def blocks_to_image_jax(blocks, height: int, width: int, block_dim: int = 8):
    """JAX version of :func:`blocks_to_image` (traceable, static shapes)."""
    bh, bw = block_grid(height, width, block_dim)
    tiles = blocks.reshape(bh, bw, block_dim, block_dim).transpose(0, 2, 1, 3)
    padded = tiles.reshape(bh * block_dim, bw * block_dim)
    return padded[:height, :width]
