"""The compiled decode kernel on a GPU (marked ``gpu``: skips elsewhere).

Run on a GPU with ``MHT_TEST_ON_GPU=1 python -m pytest tests/ -m gpu``.
The interpret-mode tests cover the kernel's arithmetic on the CPU; these
check what only the card can: that the kernel compiles for it and agrees
with the plain-XLA decode and the C++ codec at a real width.
"""

import numpy as np
import pytest

from metalhuffman import native
from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.ops import decode_pallas
from metalhuffman.utils import fixtures

pytestmark = pytest.mark.gpu


def _frames(t, h, w):
    img = fixtures.render_frame("bridge")
    big = np.tile(img, (2, 2))
    return np.stack([big[8 * i: 8 * i + h, 8 * i: 8 * i + w]
                     for i in range(t)])


def test_gpu_compiles_the_kernel():
    assert decode_pallas.interpret_mode() is False


@pytest.mark.parametrize("h,w,delta2d", [(1536, 2048, False),
                                         (1080, 1920, False),
                                         (1536, 2048, True)])
def test_kernel_matches_xla_and_native(h, w, delta2d):
    frames = _frames(4, h, w)
    outs = {}
    for backend in ("pallas", "xla"):
        cfg = CodecConfig(backend=backend, delta2d=delta2d)
        stream = frame_stream.encode_frames_shared(frames, cfg)
        prep = frame_stream.prepare_shared(stream, 4, h, w, cfg)
        outs[backend] = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(outs["pallas"], frames)
    np.testing.assert_array_equal(outs["xla"], frames)
    cfg = CodecConfig(backend="native", delta2d=delta2d)
    np.testing.assert_array_equal(
        frame_stream.decode_frames_shared(stream, 4, h, w, cfg), frames)
    assert native.available()
