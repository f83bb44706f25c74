"""Top-level convenience API."""

import numpy as np

import metalhuffman as mht
from metalhuffman.models import CodecConfig


def test_image_api():
    img = np.random.default_rng(0).integers(0, 256, (24, 32), np.uint8)
    cfg = CodecConfig(backend="xla")
    blob = mht.encode_image(img, cfg)
    np.testing.assert_array_equal(mht.decode_image(blob, cfg), img)


def test_video_api():
    frames = np.random.default_rng(1).integers(0, 256, (3, 16, 16), np.uint8)
    cfg = CodecConfig(backend="xla")
    blob = mht.encode_video(frames, cfg)
    np.testing.assert_array_equal(mht.decode_video(blob, cfg), frames)
