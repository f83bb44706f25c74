"""Decode kernel vs the NumPy oracles (Pallas interpret mode on CPU).

The kernel runs compiled on a GPU; here it runs in the Pallas interpreter
(the "serial reference decoder" role of SURVEY.md section 4). The lowering
tests lower the same kernel for CUDA without a GPU, so a kernel the Triton
route cannot express fails here, not first on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metalhuffman.core import blocks, delta, encode_symbols
from metalhuffman.ops import decode_pallas


def _roundtrip(img, use_delta=True):
    blk = blocks.image_to_blocks(img)
    payload = delta.delta_encode_blocks(blk) if use_delta else blk
    enc = encode_symbols(payload.ravel(), block_size=64)
    out = np.asarray(decode_pallas.decode_stream_pallas(enc, delta=use_delta))
    np.testing.assert_array_equal(out, blk)


@pytest.mark.parametrize("use_delta", [True, False], ids=["delta", "nodelta"])
def test_random_image(use_delta):
    rng = np.random.default_rng(0)
    _roundtrip(rng.integers(0, 256, (64, 96), np.uint8), use_delta)


def test_gradient_image():
    _roundtrip(np.add.outer(np.arange(40), np.arange(56)).astype(np.uint8))


def test_constant_image():
    _roundtrip(np.full((24, 24), 130, np.uint8))


def test_long_codes():
    rng = np.random.default_rng(7)
    p = 0.6 ** np.arange(200)
    data = rng.choice(np.arange(200), size=64 * 130, p=p / p.sum()).astype(np.uint8)
    enc = encode_symbols(data, block_size=64)
    assert enc.widths.max() > 8
    out = np.asarray(decode_pallas.decode_stream_pallas(enc, delta=False))
    np.testing.assert_array_equal(out.ravel(), data)


def test_partial_tile_padding():
    # 3 blocks << one program's lanes: padding lanes must never store.
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 64 * 3, np.uint8)
    enc = encode_symbols(data, block_size=64)
    out = np.asarray(decode_pallas.decode_stream_pallas(enc, delta=False))
    assert out.shape == (3, 64)
    np.testing.assert_array_equal(out.ravel(), data)


def test_bucket_edge_low_entropy():
    # Regression: widths {1,2,2} with ~124-bit blocks whose final symbols
    # sit 120 bits deep — the window must refill across every word edge.
    rng = np.random.default_rng(42)
    nb = 50
    blks = []
    for _ in range(nb):
        # 60 two-bit codes then 4 one-bit codes: 124-bit block whose final
        # group starts 120 bits deep.
        blks.append(np.concatenate([
            rng.integers(0, 2, 60).astype(np.uint8),  # symbols 0/1 (2-bit)
            np.full(4, 2, np.uint8),                  # symbol 2 (1-bit)
        ]))
    # enough all-2 blocks to make symbol 2 the most frequent -> width 1
    for _ in range(nb):
        blks.append(np.full(64, 2, np.uint8))
    data = np.concatenate(blks)
    enc = encode_symbols(data, block_size=64)
    assert sorted(enc.widths[enc.widths > 0].tolist()) == [1, 2, 2]
    from metalhuffman.ops import layout
    total_bits = 8 * enc.code_bytes.size - 16
    assert layout.max_block_bits(enc.block_offsets, total_bits) == 124
    out = np.asarray(decode_pallas.decode_stream_pallas(enc, delta=False))
    np.testing.assert_array_equal(out.ravel(), data)


# -- the dispatch rule --------------------------------------------------------


def test_gpu_never_interprets():
    assert decode_pallas.interpret_mode("gpu") is False


def test_cpu_interprets():
    assert decode_pallas.interpret_mode("cpu") is True
    assert decode_pallas.interpret_mode() is True  # the suite runs on CPU


@pytest.mark.parametrize("platform", ["METAL", "rocm", "neuron"])
def test_unknown_platform_refused(platform):
    with pytest.raises(RuntimeError, match="not supported"):
        decode_pallas.interpret_mode(platform)


# -- layout: the packed stream is read in place -------------------------------


def _skewed_stream(n_blocks=40, seed=5):
    rng = np.random.default_rng(seed)
    p = 0.7 ** np.arange(60)
    data = rng.choice(np.arange(60), size=64 * n_blocks,
                      p=p / p.sum()).astype(np.uint8)
    return data, encode_symbols(data, block_size=64)


def test_no_row_staging():
    """The kernel's operands are the packed words (plus 2 pad words) and
    the offset index, not W-word rows per block."""
    _, enc = _skewed_stream()
    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    assert words.size == -(-enc.code_bytes.size // 4) + 2
    np.testing.assert_array_equal(offsets, enc.block_offsets)
    assert t1.shape == (256,)


def test_offsets_choose_blocks_in_any_order():
    """Each lane starts at its own offset: a permuted offset index decodes
    the same blocks in the permuted order (what ROI selections rely on)."""
    data, enc = _skewed_stream()
    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    perm = np.random.default_rng(1).permutation(offsets.size)
    out = decode_pallas.decode(words, offsets[perm], t1, t2, delta=False)
    got = np.asarray(decode_pallas.blocks_from_words(out))
    np.testing.assert_array_equal(got, data.reshape(-1, 64)[perm])


# -- emission shapes ----------------------------------------------------------


@pytest.mark.parametrize("block_dim", [2, 4, 8, 16])
def test_block_emission_shape(block_dim):
    bs = block_dim * block_dim
    rng = np.random.default_rng(block_dim)
    data = rng.integers(0, 40, bs * 37, np.uint8)
    enc = encode_symbols(data, block_size=bs)
    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    out = decode_pallas.decode(words, offsets, t1, t2, block_dim=block_dim,
                               delta=False)
    assert out.shape == (37, bs // 4) and out.dtype == jnp.int32
    got = np.asarray(decode_pallas.blocks_from_words(out, bs))
    np.testing.assert_array_equal(got.ravel(), data)


@pytest.mark.parametrize("block_dim,h,w", [(4, 12, 20), (8, 20, 40),
                                           (16, 32, 48)])
def test_image_emission_shape(block_dim, h, w):
    """Image words cover the frame padded to whole blocks (no lane
    padding); grid widths need not be powers of two."""
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w), np.uint8)
    blk = blocks.image_to_blocks(img, block_dim)
    enc = encode_symbols(
        delta.delta_encode_blocks(blk).ravel(), block_size=block_dim ** 2)
    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    rows_pf, w_pad = decode_pallas.padded_geometry(h, w, block_dim)
    out = decode_pallas.decode(words, offsets, t1, t2, block_dim=block_dim,
                               grid_bw=w_pad // block_dim)
    assert out.shape == (rows_pf, w_pad // 4)
    got = np.asarray(decode_pallas.images_from_words(
        out, 1, h, w, block_dim))[0]
    np.testing.assert_array_equal(got, img)


def test_image_emission_rejects_partial_rows():
    _, enc = _skewed_stream(n_blocks=10)
    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    with pytest.raises(ValueError, match="whole block"):
        decode_pallas.decode(words, offsets, t1, t2, grid_bw=3)
    with pytest.raises(ValueError, match="block_dim % 4"):
        decode_pallas.decode(words, offsets, t1, t2, block_dim=2,
                             grid_bw=5)


# -- lowering for the GPU -----------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grid_bw=240),
    dict(grid_bw=256, delta=False, delta2d=True, emit_end_bits=True),
    dict(block_dim=2, emit_end_bits=True),
    dict(block_dim=16, grid_bw=120),
], ids=["blocks", "image", "delta2d-end", "bd2-end", "bd16-image"])
def test_kernel_lowers_for_cuda(kw, monkeypatch):
    """Lower the compiled (non-interpret) kernel to Triton IR for CUDA —
    the step that needs no GPU — at the headline block count."""
    from jax import export

    monkeypatch.setattr(decode_pallas, "interpret_mode",
                        lambda platform=None: False)
    nb = 30 * 192 * 256 if kw.get("block_dim", 8) == 8 else 4 * 7680
    args = (jax.ShapeDtypeStruct((200_000,), jnp.uint32),
            jax.ShapeDtypeStruct((nb,), jnp.uint32),
            jax.ShapeDtypeStruct((256,), jnp.int32),
            jax.ShapeDtypeStruct((8192,), jnp.int32))
    fn = jax.jit(lambda *a: decode_pallas.decode(*a, **kw))
    exp = export.export(
        fn, platforms=["cuda"], disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()
