"""CLI smoke tests (in-process, xla backend on CPU)."""

import numpy as np
import pytest

from metalhuffman import cli
from metalhuffman.utils import fixtures, imageio


@pytest.fixture
def gray_file(tmp_path):
    img = fixtures.render_frame("16x16_ident")
    p = tmp_path / "in.gray"
    imageio.save_grayscale(img, p)
    return p, img


def test_encode_decode_roundtrip_files(tmp_path, gray_file, capsys):
    src, img = gray_file
    mht = tmp_path / "out.mht"
    out = tmp_path / "restored.gray"
    assert cli.main(["encode", str(src), str(mht), "--backend", "xla"]) == 0
    assert cli.main(["decode", str(mht), str(out), "--backend", "xla"]) == 0
    np.testing.assert_array_equal(imageio.load_grayscale(out), img)
    assert cli.main(["info", str(mht)]) == 0
    assert "MHT1" in capsys.readouterr().out


def test_roundtrip_command(gray_file, capsys):
    src, _ = gray_file
    assert cli.main(["roundtrip", str(src), "--backend", "xla"]) == 0
    assert "bit-exact" in capsys.readouterr().out


def test_roundtrip_pallas_interpret(gray_file):
    src, _ = gray_file
    assert cli.main(
        ["roundtrip", str(src), "--backend", "pallas", "--interpret"]
    ) == 0


def test_video_roundtrip_shared(tmp_path, capsys):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 24, 32), np.uint8)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtv = tmp_path / "out.mhtv"
    outdir = tmp_path / "decoded.npy"
    assert cli.main(["encode-video", str(src), str(mhtv),
                     "--backend", "pallas", "--interpret"]) == 0
    assert cli.main(["info", str(mhtv)]) == 0
    assert "MHTV" in capsys.readouterr().out
    assert cli.main(["decode-video", str(mhtv), str(outdir),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(outdir), frames)


def test_video_roundtrip_per_frame(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 16, 16), np.uint8)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhts = tmp_path / "out.mhts"
    outdir = tmp_path / "imgs"
    assert cli.main(["encode-video", str(src), str(mhts),
                     "--per-frame-tables", "--backend", "xla"]) == 0
    assert cli.main(["decode-video", str(mhts), str(outdir),
                     "--backend", "xla"]) == 0
    from metalhuffman.utils import imageio

    f0 = imageio.load_grayscale(outdir / "frame_00000.png")
    np.testing.assert_array_equal(f0, frames[0])


def test_decode_video_check_requires_pallas(tmp_path):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 16, 16), np.uint8)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtv = tmp_path / "out.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv),
                     "--backend", "pallas", "--interpret"]) == 0
    with pytest.raises(SystemExit, match="pallas"):
        cli.main(["decode-video", str(mhtv), str(tmp_path / "o.npy"),
                  "--check", "--backend", "native"])
    with pytest.raises(SystemExit, match="pallas"):
        cli.main(["decode-video", str(mhtv), str(tmp_path / "o.npy"),
                  "--check", "--backend", "xla"])


def test_decode_video_check_mhts(tmp_path):
    """--check covers MHTS too (per-frame checked decode; review finding)."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2, 16, 16), np.uint8)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhts = tmp_path / "out.mhts"
    out = tmp_path / "o.npy"
    assert cli.main(["encode-video", str(src), str(mhts),
                     "--per-frame-tables", "--backend", "pallas",
                     "--interpret"]) == 0
    assert cli.main(["decode-video", str(mhts), str(out), "--check",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)


def test_video_zero_init_cli(tmp_path):
    """--zero-init is honored on the (default) shared-table video path."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 16, 24), np.uint8)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtv = tmp_path / "out.mhtv"
    out = tmp_path / "o.npy"
    assert cli.main(["encode-video", str(src), str(mhtv), "--zero-init",
                     "--backend", "pallas", "--interpret"]) == 0
    from metalhuffman.models import frame_stream

    stream, *_ = frame_stream.read_shared(mhtv.read_bytes())
    assert stream.block_init is not None
    assert cli.main(["decode-video", str(mhtv), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)


def _rgb_img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r = np.clip(120 + 80 * np.sin(xx / 9.0), 0, 255)
    g = np.clip(100 + 80 * np.cos(yy / 7.0), 0, 255)
    b = np.clip(90 + rng.normal(0, 12, (h, w)), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def test_color_image_cli(tmp_path, capsys):
    from metalhuffman.utils import imageio

    img = _rgb_img(24, 32)
    src = tmp_path / "in.png"
    imageio.save_color(img, src)
    mhtc = tmp_path / "out.mhtc"
    out = tmp_path / "restored.png"
    assert cli.main(["encode", str(src), str(mhtc), "--color",
                     "--backend", "pallas", "--interpret"]) == 0
    assert cli.main(["info", str(mhtc)]) == 0
    assert "MHTC" in capsys.readouterr().out
    assert cli.main(["decode", str(mhtc), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(imageio.load_color(out), img)
    assert cli.main(["verify", str(mhtc),
                     "--backend", "pallas", "--interpret"]) == 0
    assert "PASS" in capsys.readouterr().out
    assert cli.main(["roundtrip", str(src), "--color",
                     "--backend", "pallas", "--interpret"]) == 0
    assert "bit-exact" in capsys.readouterr().out


def test_color_video_cli(tmp_path, capsys):
    from metalhuffman.utils import imageio

    frames = np.stack([_rgb_img(16, 24, seed=i) for i in range(3)])
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtc = tmp_path / "out.mhtc"
    out = tmp_path / "decoded.npy"
    assert cli.main(["encode-video", str(src), str(mhtc), "--color",
                     "--backend", "pallas", "--interpret"]) == 0
    assert cli.main(["decode-video", str(mhtc), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)
    # temporal random access on the color container
    one = tmp_path / "frame1.png"
    assert cli.main(["decode-video", str(mhtc), str(one), "--frame", "1",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(imageio.load_color(one), frames[1])
    # on-device end-bit integrity check rides the inner plane stream
    assert cli.main(["decode-video", str(mhtc), str(out), "--check",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)
    capsys.readouterr()
    assert cli.main(["verify", str(mhtc),
                     "--backend", "pallas", "--interpret"]) == 0
    assert "PASS" in capsys.readouterr().out
    # an MHTC video refuses the single-image decoder
    with pytest.raises(SystemExit, match="decode-video"):
        cli.main(["decode", str(mhtc), str(tmp_path / "x.png")])


def test_gray16_cli(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 1 << 16, (24, 32))).astype(np.uint16)
    src = tmp_path / "depth.npy"
    np.save(src, img)
    mhtc = tmp_path / "out.mhtc"
    out = tmp_path / "restored.npy"
    assert cli.main(["encode", str(src), str(mhtc), "--gray16",
                     "--backend", "pallas", "--interpret"]) == 0
    assert cli.main(["decode", str(mhtc), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    restored = np.load(out)
    assert restored.dtype == np.uint16
    np.testing.assert_array_equal(restored, img)


def test_gray16_video_cli(tmp_path):
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 1 << 16, (2, 16, 24)).astype(np.uint16)
    src = tmp_path / "depth.npy"
    np.save(src, frames)
    mhtc = tmp_path / "out.mhtc"
    out = tmp_path / "restored.npy"
    assert cli.main(["encode-video", str(src), str(mhtc), "--gray16",
                     "--backend", "pallas", "--interpret"]) == 0
    assert cli.main(["decode-video", str(mhtc), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    restored = np.load(out)
    assert restored.dtype == np.uint16
    np.testing.assert_array_equal(restored, frames)
    one = tmp_path / "f1.npy"
    assert cli.main(["decode-video", str(mhtc), str(one), "--frame", "1",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(one), frames[1])


def test_color_subgreen_and_best_cli(tmp_path, capsys):
    from metalhuffman.utils import imageio

    # luma-shared channels: sub-green should win and --best should find it
    rng = np.random.default_rng(17)
    luma = (np.cumsum(rng.integers(-4, 5, (32, 40)), axis=1) + 128)
    img = np.stack([np.clip(luma + rng.integers(-3, 4, luma.shape), 0, 255),
                    np.clip(luma, 0, 255),
                    np.clip(luma + rng.integers(-3, 4, luma.shape), 0, 255)],
                   axis=-1).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_color(img, src)
    sub = tmp_path / "sub.mhtc"
    best = tmp_path / "best.mhtc"
    ident = tmp_path / "ident.mhtc"
    out = tmp_path / "restored.png"
    for flags, path in ([["--subgreen"], sub], [["--best"], best], [[], ident]):
        assert cli.main(["encode", str(src), str(path), "--color", *flags,
                         "--backend", "pallas", "--interpret"]) == 0
    assert sub.stat().st_size < ident.stat().st_size
    assert best.stat().st_size <= sub.stat().st_size
    for path in (sub, best):
        assert cli.main(["decode", str(path), str(out),
                         "--backend", "pallas", "--interpret"]) == 0
        np.testing.assert_array_equal(imageio.load_color(out), img)
    capsys.readouterr()
    assert cli.main(["info", str(sub)]) == 0
    assert "sub-green" in capsys.readouterr().out


def test_color_video_subgreen_cli(tmp_path):
    from metalhuffman.models import color as color_mod
    from metalhuffman.utils import imageio

    frames = np.stack([_rgb_img(16, 24, seed=i) for i in range(2)])
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtc = tmp_path / "out.mhtc"
    out = tmp_path / "decoded.npy"
    assert cli.main(["encode-video", str(src), str(mhtc), "--color",
                     "--subgreen", "--backend", "pallas", "--interpret"]) == 0
    assert color_mod.unwrap(mhtc.read_bytes())[4] == color_mod.CS_SUBGREEN
    assert cli.main(["decode-video", str(mhtc), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)
    one = tmp_path / "f1.png"
    assert cli.main(["decode-video", str(mhtc), str(one), "--frame", "1",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(imageio.load_color(one), frames[1])


def test_cli_flag_validation(tmp_path):
    rng = np.random.default_rng(23)
    stack16 = rng.integers(0, 1 << 16, (3, 8, 8)).astype(np.uint16)
    np.save(tmp_path / "stack.npy", stack16)
    frames = rng.integers(0, 256, (2, 8, 8, 3), np.uint8)
    np.save(tmp_path / "color.npy", frames)
    out = str(tmp_path / "o.mhtc")
    # encode (image) refuses a 3-D gray16 stack
    with pytest.raises(SystemExit, match="encode-video"):
        cli.main(["encode", str(tmp_path / "stack.npy"), out, "--gray16"])
    # MHTC output has no per-frame-tables mode
    with pytest.raises(SystemExit, match="per-frame-tables"):
        cli.main(["encode-video", str(tmp_path / "color.npy"), out,
                  "--color", "--per-frame-tables"])
    # subgreen without color is meaningless
    with pytest.raises(SystemExit, match="--color"):
        cli.main(["encode", str(tmp_path / "stack.npy"), out, "--subgreen"])


def test_grayscale_best_cli(tmp_path, capsys):
    from metalhuffman.utils import fixtures, imageio

    img = fixtures.render_frame("bridge")  # real photo: a precoder should win
    src = tmp_path / "in.png"
    imageio.save_grayscale(img, src)
    best = tmp_path / "best.mht"
    plain = tmp_path / "plain.mht"
    out = tmp_path / "restored.png"
    assert cli.main(["encode", str(src), str(best), "--best",
                     "--backend", "xla"]) == 0
    assert cli.main(["encode", str(src), str(plain), "--no-delta",
                     "--backend", "xla"]) == 0
    assert best.stat().st_size < plain.stat().st_size
    assert cli.main(["decode", str(best), str(out), "--backend", "xla"]) == 0
    np.testing.assert_array_equal(imageio.load_grayscale(out), img)


def test_color_frame_native_backend_cli(tmp_path):
    from metalhuffman.utils import imageio

    frames = np.stack([_rgb_img(16, 24, seed=i) for i in range(2)])
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    mhtc = tmp_path / "out.mhtc"
    assert cli.main(["encode-video", str(src), str(mhtc), "--color",
                     "--backend", "native"]) == 0
    one = tmp_path / "f0.png"
    assert cli.main(["decode-video", str(mhtc), str(one), "--frame", "0",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(imageio.load_color(one), frames[0])
