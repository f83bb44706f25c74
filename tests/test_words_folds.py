"""Round-5 packed-words fold extensions (verdict weak item 1 / next #2).

Every production temporal chain now folds on the kernel's PACKED int32
words: color planes (linear-cs commutation), u16 hi/lo pairs (SWAR carry
propagation), and motion compensation on PADDED strip geometries (double
roll + byte-lane mask select). These tests pin each new primitive against
a NumPy oracle and drive the full device decode path (interpret backend)
for every kind x motion x geometry combination.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metalhuffman.models import CodecConfig, temporal  # noqa: E402
from metalhuffman.models import color as color_mod  # noqa: E402

NATIVE = CodecConfig(backend="native")
DEV = CodecConfig(backend="pallas")


def _pack_words(img, rows_pf, w_pad):
    """(H, W) uint8 -> padded (rows_pf, w_pad//4) int32 little-endian."""
    h, w = img.shape
    p = np.zeros((rows_pf, w_pad), np.uint8)
    p[:h, :w] = img
    return p.view("<u4").astype(np.uint32).view(np.int32).copy()


def _unpack_words(words, h, w):
    return np.asarray(words).view("<u4").view(np.uint8).reshape(
        words.shape[0], -1)[:h, :w]


@pytest.mark.parametrize("geom", [(16, 32, 16, 32), (13, 29, 16, 32),
                                  (16, 29, 16, 32), (13, 32, 16, 32)])
def test_roll_words_general_matches_np_roll(geom):
    h, w, rows_pf, w_pad = geom
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (h, w), np.uint8)
    words = jnp.asarray(_pack_words(img, rows_pf, w_pad))
    for dy, dx in [(0, 0), (1, 0), (0, 1), (3, 5), (h - 1, w - 1),
                   (5, 3), (2 % h, 31 % w), (7 % h, 17 % w)]:
        # the fold normalizes vectors mod (height, width) before rolling
        # (temporal_fold_words_mc_jax) — match that precondition here
        rolled = temporal._roll_words_general(
            words, jnp.int32(dy), jnp.int32(dx), h, w)
        got = _unpack_words(rolled, h, w)
        np.testing.assert_array_equal(
            got, np.roll(img, (dy, dx), (0, 1)),
            err_msg=f"dy={dy} dx={dx} geom={geom}")


def test_swar_add8_carry_oracle():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, 256, np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 256, np.uint64).astype(np.uint32)
    s, c = temporal._swar_add8_carry(jnp.asarray(a.view(np.int32)),
                                     jnp.asarray(b.view(np.int32)))
    ab = a.view(np.uint8).astype(np.uint16)
    bb = b.view(np.uint8).astype(np.uint16)
    full = ab + bb
    np.testing.assert_array_equal(
        np.asarray(s).view(np.uint8), (full & 0xFF).astype(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(c).view(np.uint8), (full >> 8).astype(np.uint8))


def test_u16_words_fold_matches_oracle():
    rng = np.random.default_rng(3)
    t, h, w = 9, 8, 16
    frames = rng.integers(0, 1 << 16, (t, h, w)).astype(np.uint16)
    keyint = 4
    res = temporal.temporal_encode(frames, keyint)
    planes = np.stack([(res >> 8).astype(np.uint8),
                       (res & 0xFF).astype(np.uint8)],
                      axis=1).reshape(t * 2, h, w)
    words = jnp.asarray(np.stack([_pack_words(p, h, w) for p in planes]))
    folded = temporal.temporal_fold_u16_words_jax(words, keyint)
    out = np.asarray(folded).view("<u4").view(np.uint8).reshape(
        t, 2, h, w).astype(np.uint16)
    got = (out[:, 0] << 8) | out[:, 1]
    np.testing.assert_array_equal(got, frames)


def test_plane_words_fold_matches_oracle_subgreen():
    rng = np.random.default_rng(4)
    t, h, w, c = 7, 8, 16, 3
    frames = rng.integers(0, 256, (t, h, w, c), np.uint8)
    keyint = 3
    res = temporal.temporal_encode(frames, keyint)
    sg = color_mod.to_subgreen(res)
    planes = sg.transpose(0, 3, 1, 2).reshape(t * c, h, w)
    words = jnp.asarray(np.stack([_pack_words(p, h, w) for p in planes]))
    folded = temporal.temporal_fold_plane_words_jax(words, keyint, c)
    planes_f = np.asarray(folded).view("<u4").view(np.uint8).reshape(
        t * c, h, w)
    got = color_mod.fold_video_planes(planes_f, c, color_mod.KIND_U8,
                                      color_mod.CS_SUBGREEN)
    np.testing.assert_array_equal(got, frames)


def _clip(kind, t, h, w, seed, pan=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    gray = np.stack([
        np.clip(120 + 80 * np.sin((xx + pan * i) / 13.0)
                * np.cos((yy + 2 * i) / 11.0)
                + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        for i in range(t)])
    if kind == "gray":
        return gray
    if kind == "color":
        return np.stack([gray, np.roll(gray, 2, 2),
                         np.roll(gray, 4, 2)], axis=-1)
    return ((gray.astype(np.uint16) << 5) | (gray >> 3)).astype(np.uint16)


@pytest.mark.parametrize("geometry", ["exact", "padded"],
                         ids=["exact", "padded"])
@pytest.mark.parametrize("motion", [False, True], ids=["plain", "mc"])
@pytest.mark.parametrize("kind", ["gray", "color", "u16"])
def test_device_fold_chain_every_kind(kind, motion, geometry):
    """The full _decode_temporal_device chain (interpret backend) against
    the host reconstruction, for every production fold combination."""
    # padded: width not a multiple of 8 -> pad columns; odd height -> pad
    # rows. exact: (16, 512), nothing padded.
    h, w = (16, 512) if geometry == "exact" else (13, 500)
    t = 9
    frames = _clip(kind, t, h, w, seed=7, pan=6 if motion else 0)
    cfg = CodecConfig(backend="native", temporal=True, motion=motion,
                      keyint=4)
    if kind == "gray":
        blob = temporal.encode_temporal_video(frames, cfg)
    elif kind == "color":
        blob = temporal.encode_temporal_color_video(
            frames, cfg, colorspace=color_mod.CS_SUBGREEN)
    else:
        blob = temporal.encode_temporal_gray16_video(frames, cfg)
    host = temporal.decode_temporal_video(blob, NATIVE)
    np.testing.assert_array_equal(host, frames)
    dev = temporal.decode_temporal_video(blob, DEV)
    assert dev.dtype == frames.dtype
    np.testing.assert_array_equal(dev, frames)


def test_device_fold_short_first_group():
    """Arbitrary-start extraction's short first group rides the new
    packed folds too (front-padding)."""
    from metalhuffman.models import surgery

    frames = _clip("color", 11, 13, 100, seed=9)
    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    blob = temporal.encode_temporal_color_video(frames, cfg)
    ext = surgery.extract_video(blob, 2, 11)  # mid-group start
    dev = temporal.decode_temporal_video(ext, DEV)
    np.testing.assert_array_equal(dev, frames[2:])


def test_zero_init_keeps_byte_fallback():
    """Zero-init streams fold block_init on byte images — the strips
    probe must route them to the fallback, which still reconstructs."""
    frames = _clip("gray", 6, 16, 64, seed=11)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3,
                      zero_init=True)
    blob = temporal.encode_temporal_video(frames, cfg)
    assert not temporal._strips_available(temporal.unwrap(blob)[0])
    dev = temporal.decode_temporal_video(blob, DEV)
    np.testing.assert_array_equal(dev, frames)
