"""The bench's temporal reconstruction modes stay bit-exact (CPU interpret).

bench.py gates every timed path against the NumPy oracle before timing;
these tests run those gates at tiny geometry on the 8-device CPU mesh
env (interpret-mode kernel), so a refactor that silently breaks a bench
mode's fold chain fails here instead of on the GPU. ``bench.main`` itself
refuses any platform but a GPU.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


@pytest.mark.parametrize("motion,inner,width", [
    (False, "color", 512),
    (False, "u16", 512),
    (True, "gray", 512),
    (True, "gray", 1024),
    (True, "color", 512),
])
def test_run_temporal_ext_bit_exact(motion, inner, width):
    # run_temporal_ext sys.exit(1)s on any decode/fold mismatch — a clean
    # return IS the assertion (plus a sane positive rate)
    gbps, reps, _spread = bench.run_temporal_ext(
        64, width, 5, 2, verbose=False, variants=2, keyint=3,
        motion=motion, inner=inner)
    assert gbps > 0 and reps >= 1


def test_run_temporal_plain_bit_exact():
    gbps, reps, _spread = bench.run_temporal(
        64, 512, 5, 2, verbose=False, variants=2, keyint=3)
    assert gbps > 0 and reps >= 1


def test_bench_refuses_cpu(monkeypatch):
    """A measurement path never falls back to the CPU (it would time the
    Pallas interpreter): bench.main exits before measuring."""
    monkeypatch.setattr(sys, "argv", ["bench.py", "--frames", "1"])
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
