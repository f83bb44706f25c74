"""delta2d: the 2-D within-block predictor (beyond-reference mode 3/4).

Row 0 is delta-left, rows below are delta-up (``core.delta``), so residuals
never cross a block boundary and block-parallel decode is preserved. Every
decode backend emits raw residuals (delta=False in-chain) and a vectorized
post-pass inverts the predictor; the zero-init root fold composes unchanged
because the root byte propagates additively through both running sums.

The reference's only precoder is the 1-D raster delta
(``AAPLRenderer.m:432-515``); on photographic content the 2-D predictor is
~3 entropy points (10-15% compressed size) smaller — gated below on the
committed real-photo asset.
"""

import dataclasses

import numpy as np
import pytest

import metalhuffman as mht
from metalhuffman.core import container, delta as delta_mod
from metalhuffman.models import ImageCodec, frame_stream
from metalhuffman.models.image_codec import CodecConfig


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 4, (h, w)), axis=1)
    base += np.cumsum(rng.normal(0, 4, (h, w)), axis=0)
    return (base - base.min()).clip(0, 255).astype(np.uint8)


def test_transform_is_exact_inverse():
    rng = np.random.default_rng(1)
    for bd in (4, 8, 16):
        blocks = rng.integers(0, 256, (57, bd * bd), np.uint8)
        res = delta_mod.delta2d_encode_blocks(blocks, bd)
        assert np.array_equal(
            delta_mod.delta2d_decode_blocks(res, bd), blocks)


def test_transform_semantics():
    # row 0 delta-left, rows below delta-up, all mod 256
    b = np.arange(64, dtype=np.uint8).reshape(1, 64)
    res = delta_mod.delta2d_encode_blocks(b, 8).reshape(8, 8)
    sq = b.reshape(8, 8)
    assert res[0, 0] == sq[0, 0]
    assert np.array_equal(res[0, 1:], (sq[0, 1:] - sq[0, :-1]) & 0xFF)
    assert np.array_equal(res[1:], (sq[1:].astype(int) - sq[:-1]) & 0xFF)


@pytest.mark.parametrize("backend", ["native", "xla", "pallas"])
@pytest.mark.parametrize("zero_init", [False, True])
def test_image_roundtrip_all_backends(backend, zero_init):
    img = _img(45, 67, seed=2)  # odd geometry: partial edge blocks
    cfg = CodecConfig(backend=backend, delta2d=True, zero_init=zero_init)
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    assert stream.predictor == "2d"
    assert (stream.block_init is not None) == zero_init
    out = np.asarray(codec.decode(stream, 45, 67))
    np.testing.assert_array_equal(out, img)


def test_mht1_container_mode_is_authoritative():
    img = _img(32, 48, seed=3)
    blob = ImageCodec(
        CodecConfig(backend="native", delta2d=True)).encode_to_bytes(img)
    # a default-config codec must decode it from the header alone (and the
    # recorded CRC-32 verifies the payload end to end)
    out = ImageCodec(CodecConfig(backend="native")).decode(blob)
    np.testing.assert_array_equal(out, img)
    stream, _h, _w, _bd, delta, _crc = container.read_frame(blob)
    assert delta and stream.predictor == "2d"


def test_mht1_zero_init_delta2d_mode4():
    img = _img(32, 32, seed=4)
    cfg = CodecConfig(backend="native", delta2d=True, zero_init=True)
    blob = ImageCodec(cfg).encode_to_bytes(img)
    assert blob[17] == 4  # mode byte: delta2d + zero-init
    stream, *_ = container.read_frame(blob)
    assert stream.predictor == "2d" and stream.block_init is not None
    out = ImageCodec(CodecConfig(backend="native")).decode(blob)
    np.testing.assert_array_equal(out, img)


def test_video_mhtv_and_mhv2_roundtrip():
    rng = np.random.default_rng(5)
    frames = np.stack([_img(32, 48, seed=10 + i) for i in range(3)])
    cfg = CodecConfig(backend="native", delta2d=True)
    blob = mht.encode_video(frames, cfg)
    got = mht.decode_video(blob, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, frames)

    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=32 * 48 * 16)
    assert len(segs) >= 2
    sb = frame_stream.write_segmented(segs, 32, 48, cfg)
    got = mht.decode_video(sb, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, frames)


def test_shared_pallas_checked_decode():
    frames = np.stack([_img(32, 48, seed=20 + i) for i in range(2)])
    cfg = CodecConfig(backend="pallas", delta2d=True)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 32, 48, cfg, check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any()
    np.testing.assert_array_equal(np.asarray(out), frames)


def test_raw_strips_carry_in_kernel_reconstruction():
    # delta2d reconstructs in kernel registers, so even the zero-post-op
    # raw-words production path returns final pixels — unlike zero-init,
    # whose fold stays outside the kernel
    frames = np.stack([_img(64, 2048, seed=30)])
    cfg = CodecConfig(backend="pallas", delta2d=True)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 1, 64, 2048, cfg)
    raw = frame_stream.decode_shared_step(prep, cfg, raw=True)
    assert raw.shape == (1, 64, 512)
    out = frame_stream.frames_from_raw(raw, 1, 64, 2048)
    np.testing.assert_array_equal(out, frames)


def test_mhts_per_frame_tables():
    frames = np.stack([_img(24, 32, seed=40 + i) for i in range(2)])
    cfg = CodecConfig(backend="xla", delta2d=True)
    streams = frame_stream.encode_frames(frames, cfg)
    blob = frame_stream.write_stream(streams, 24, 32, cfg)
    streams2, h, w, bd, delta = frame_stream.read_stream(blob)
    assert all(s.predictor == "2d" for s in streams2)
    prep = frame_stream.prepare_batch(streams2, h, w, cfg)
    out = np.asarray(frame_stream.decode_batch(prep, cfg))
    np.testing.assert_array_equal(out, frames)


def test_decode_region():
    img = _img(45, 67, seed=6)
    codec = ImageCodec(CodecConfig(backend="xla", delta2d=True))
    stream = codec.encode(img)
    reg = codec.decode_region(stream, 45, 67, 5, 9, 17, 23)
    np.testing.assert_array_equal(reg, img[5:22, 9:32])


def test_streaming_decoder_uses_image_path():
    frames = np.stack([_img(64, 2048, seed=50)])
    cfg = CodecConfig(backend="pallas", delta2d=True)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    dec = frame_stream.StreamingDecoder(cfg)
    out = dec.result(dec.submit(stream, 1, 64, 2048))
    np.testing.assert_array_equal(out, frames)


def test_compression_gain_on_real_photo():
    from PIL import Image

    photo = np.asarray(
        Image.open("tests/assets/bridge_512x512.png").convert("L"))
    s_left = ImageCodec(CodecConfig()).encode(photo)
    s_2d = ImageCodec(CodecConfig(delta2d=True)).encode(photo)
    # the gate: the 2-D predictor must beat the reference's raster delta
    # on real photographic content (observed ~15% on this asset)
    assert s_2d.compressed_size < 0.95 * s_left.compressed_size
    best, used = ImageCodec(CodecConfig()).encode_best(photo)
    assert used and best.predictor == "2d"
    assert best.compressed_size == s_2d.compressed_size


def test_cli_encode_decode_verify(tmp_path, capsys):
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    img = _img(32, 48, seed=7)
    src = tmp_path / "in.gray"
    imageio.save_grayscale(img, src)
    out_mht = tmp_path / "a.mht"
    assert cli.main(["encode", str(src), str(out_mht), "--delta2d",
                     "--backend", "native"]) == 0
    capsys.readouterr()
    assert cli.main(["info", str(out_mht)]) == 0
    assert "delta2d" in capsys.readouterr().out
    # decode without re-specifying the flag: header is authoritative
    restored = tmp_path / "out.gray"
    assert cli.main(["decode", str(out_mht), str(restored),
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(
        imageio.load_grayscale(restored), img)
    capsys.readouterr()
    assert cli.main(["verify", str(out_mht), "--backend", "pallas",
                     "--interpret"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "delta2d" in out


def test_cli_video_delta2d(tmp_path):
    from metalhuffman import cli

    frames = np.stack([_img(16, 32, seed=60 + i) for i in range(2)])
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhtv = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv), "--delta2d",
                     "--backend", "pallas", "--interpret"]) == 0
    out = tmp_path / "o.npy"
    assert cli.main(["decode-video", str(mhtv), str(out), "--check",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)


def test_cli_encode_video_best(tmp_path, capsys):
    from metalhuffman import cli

    # real photographic content: delta2d must win (PERF.md predictor study)
    from PIL import Image

    photo = np.asarray(
        Image.open("tests/assets/bridge_512x512.png").convert("L"))
    frames = np.stack([photo[:256, :256], photo[256:, 256:]])
    src = tmp_path / "f.npy"
    np.save(src, frames)
    out = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(out), "--best",
                     "--backend", "native"]) == 0
    assert "--best picked precoder: delta2d" in capsys.readouterr().err
    stream, *_ = frame_stream.read_shared(out.read_bytes())
    assert stream.predictor == "2d"
    np.testing.assert_array_equal(
        mht.decode_video(out.read_bytes(), CodecConfig(backend="native")),
        frames)

    # incompressible noise: no precoder helps -> none
    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (2, 24, 32), np.uint8)
    np.save(src, noisy)
    assert cli.main(["encode-video", str(src), str(out), "--best",
                     "--backend", "native"]) == 0
    assert "picked precoder: none" in capsys.readouterr().err


def test_color_delta2d():
    from metalhuffman.models import color

    rng = np.random.default_rng(8)
    img = np.stack([_img(24, 32, seed=70 + i) for i in range(3)], axis=-1)
    cfg = CodecConfig(backend="native", delta2d=True)
    blob = color.encode_color_to_bytes(img, cfg)
    out = color.decode_color_from_bytes(blob, CodecConfig(backend="native"))
    np.testing.assert_array_equal(out, img)
