"""Vectorized XLA decode vs the serial NumPy oracle (bit-exactness gate)."""

import numpy as np
import pytest

from metalhuffman.core import blocks, decode_ref, delta, encode_symbols, tables
from metalhuffman.ops import decode_xla, layout


def _roundtrip_image(img: np.ndarray, use_delta: bool = True):
    blk = blocks.image_to_blocks(img)
    payload = delta.delta_encode_blocks(blk) if use_delta else blk
    enc = encode_symbols(payload.ravel(), block_size=64)
    out = np.asarray(decode_xla.decode_stream(enc, delta=use_delta))
    assert out.shape == blk.shape
    np.testing.assert_array_equal(out, blk)
    back = blocks.blocks_to_image(out, *img.shape)
    np.testing.assert_array_equal(back, img)
    return enc


@pytest.mark.parametrize("use_delta", [True, False], ids=["delta", "nodelta"])
@pytest.mark.parametrize(
    "name,maker",
    [
        ("gradient", lambda rng: np.add.outer(
            np.arange(64), np.arange(96)).astype(np.uint8)),
        ("random", lambda rng: rng.integers(0, 256, (64, 96), np.uint8)),
        ("sparse", lambda rng: np.where(
            rng.random((64, 96)) < 0.98, 0, rng.integers(1, 256, (64, 96))
        ).astype(np.uint8)),
        ("constant", lambda rng: np.full((32, 40), 77, np.uint8)),
        ("two_tone", lambda rng: rng.choice([0, 255], (48, 48)).astype(np.uint8)),
        ("nonsquare", lambda rng: rng.integers(0, 256, (6, 4), np.uint8)),
        ("tiny", lambda rng: rng.integers(0, 256, (4, 4), np.uint8)),
    ],
)
def test_image_roundtrip(name, maker, use_delta):
    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    _roundtrip_image(maker(rng), use_delta)


def test_matches_serial_oracle_per_block():
    rng = np.random.default_rng(3)
    data = rng.choice(
        [0, 1, 2, 5, 17, 200, 255], size=64 * 64,
        p=[0.5, 0.2, 0.1, 0.08, 0.06, 0.04, 0.02],
    ).astype(np.uint8)
    enc = encode_symbols(data, block_size=64)
    st = tables.build_split_tables(enc.widths)
    out = np.asarray(decode_xla.decode_stream(enc, delta=False))
    for b in range(out.shape[0]):
        oracle = decode_ref.decode_split_tables(
            enc.code_bytes, st, 64, start_bit=int(enc.block_offsets[b])
        )
        np.testing.assert_array_equal(out[b], oracle)


def test_long_codes_trigger_t2_escapes():
    # Skewed distribution guarantees codes longer than 8 bits (T2 path).
    rng = np.random.default_rng(11)
    vals = np.arange(200)
    p = 0.6 ** np.arange(200)
    p /= p.sum()
    data = rng.choice(vals, size=64 * 256, p=p).astype(np.uint8)
    enc = encode_symbols(data, block_size=64)
    assert enc.widths.max() > 8  # escapes actually exercised
    out = np.asarray(decode_xla.decode_stream(enc, delta=False))
    np.testing.assert_array_equal(out.ravel(), data)


def test_width_buckets():
    assert layout.words_per_block(1) == layout.WORD_BUCKETS[0]
    assert layout.words_per_block(64 * 16) == layout.MAX_WORDS_PER_BLOCK
    for mb in [10, 100, 300, 500, 700, 1024]:
        w = layout.words_per_block(mb)
        assert (31 + mb - 1) // 32 + 2 <= w


def test_layout_np_equals_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 64 * 32, np.uint8)
    enc = encode_symbols(data, block_size=64)
    words, offs, width = decode_xla.prepare_stream(enc)
    rows_np, init_np = layout.build_layout_np(words, offs, width)
    rows_j, init_j = layout.build_layout_jax(jnp.asarray(words), jnp.asarray(offs), width)
    np.testing.assert_array_equal(rows_np, np.asarray(rows_j))
    np.testing.assert_array_equal(init_np, np.asarray(init_j))
