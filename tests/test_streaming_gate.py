"""The one-command streaming gate (scripts/streaming_gate.py) runs in the
suite at small geometry on the interpret backend — the same script that
certifies the family on the GPU."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_streaming_gate_interpret():
    r = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "streaming_gate.py"),
         "--interpret", "--height", "16", "--width", "64", "--frames",
         "4"],
        capture_output=True, text=True, cwd=str(REPO), timeout=1800)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STREAMING GATE: ALL PASS" in r.stdout
