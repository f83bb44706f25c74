"""Non-default block dimensions across backends (HUFF_BLOCK_DIM analog)."""

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, ImageCodec
from metalhuffman.ops import layout


@pytest.mark.parametrize("block_dim", [2, 4, 16])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_roundtrip_block_dims(block_dim, backend):
    rng = np.random.default_rng(block_dim)
    img = rng.integers(0, 200, (64, 96), np.uint8)
    codec = ImageCodec(CodecConfig(
        block_dim=block_dim, backend=backend))
    codec.roundtrip_verify(img)


def test_words_per_block_large_blocks():
    # 256-symbol blocks can need 130 words — must not cap at the bucket table
    need_bits = 256 * 16
    w = layout.words_per_block(need_bits, symbols_per_block=256)
    assert w >= (31 + need_bits - 1) // 32 + 2
    # small cases still land on the bucket table
    assert layout.words_per_block(100, symbols_per_block=64) in layout.WORD_BUCKETS


def test_pallas_rejects_non_multiple_of_4():
    import jax.numpy as jnp

    from metalhuffman.ops import decode_pallas, decode_xla

    t1, t2 = decode_xla.prepare_tables(np.array([8] * 256, np.uint8))
    with pytest.raises(ValueError, match="block_dim 3"):
        decode_pallas.decode(
            jnp.zeros(8, jnp.uint32), jnp.zeros(4, jnp.uint32),
            jnp.asarray(t1), jnp.asarray(t2), block_dim=3)
