"""One-command re-certification of the STREAMING family, end to end.

The streaming family's bit-exactness on the device path is certified by
this one repeatable gate:

    python scripts/streaming_gate.py              # GPU (the decode kernel)
    python scripts/streaming_gate.py --interpret  # CPU (CI / default tier)

It drives the PRODUCT surface (the CLI, one subprocess per command — the
same processes a user runs) through every streaming writer/reader pair
and asserts bit-exactness against the source frames:

  1. gray MHV2:  encode --streaming -> decode --streaming -> verify
     --streaming (end-bit per segment on pallas)
  2. corrupted CRC trailer must FAIL the streamed verify/decode
  3. MHTC color (sub-green): streamed both directions
  4. MHTC u16: streamed both directions
  5. MHVT temporal+motion (round-5 trailer layout): streamed encode ->
     streamed group-chunked decode through the DEVICE fold -> verify
     --streaming -> --frame N --check random access
  6. MHTS per-frame tables: streamed encode -> streamed decode --check
  7. resegment (streamed, file-to-file) -> verify --streaming
  8. capture RESUME: --append continues the temporal container in place,
     byte-identical to the one-shot capture

Prints one PASS line per stage and exits non-zero on the first failure.
First it asks the CLI which JAX platform it runs on and fails unless that
is the CPU with ``--interpret`` and the GPU without. Runs from anywhere;
never starts two device processes at once (commands run serially).
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true",
                    help="run the device paths on CPU (interpret kernel)")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    dev = ["--interpret"] if args.interpret else []
    h, w, t = args.height, args.width, args.frames
    plat = subprocess.run(
        [sys.executable, "-m", "metalhuffman", "platform", *dev],
        capture_output=True, text=True, cwd=str(REPO)).stdout.split()
    want = "cpu" if args.interpret else "gpu"
    if not plat or plat[0] != want:
        print(f"FAIL: the CLI runs on {plat[:2]}, expected {want}")
        return 1
    print(f"PASS  CLI platform: {' '.join(plat)}", flush=True)

    from metalhuffman.utils import fixtures

    img = fixtures.render_frame("bridge")
    img = np.tile(img, ((h - 1) // img.shape[0] + 1,
                        (w - 1) // img.shape[1] + 1))[:h, :w]
    gray = np.stack([np.roll(img, (3 * i, 5 * i), (0, 1))
                     for i in range(t)])
    color = np.stack([gray, np.roll(gray, 2, 2), np.roll(gray, 4, 2)],
                     axis=-1)
    u16 = ((gray.astype(np.uint16) << 4) | (gray >> 4)).astype(np.uint16)

    tmp = Path(tempfile.mkdtemp(prefix="mht_gate_"))
    np.save(tmp / "gray.npy", gray)
    np.save(tmp / "color.npy", color)
    np.save(tmp / "u16.npy", u16)

    def run(*a, expect_fail=False):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "metalhuffman", *a],
                           capture_output=True, text=True, cwd=str(REPO))
        dt = time.perf_counter() - t0
        if expect_fail:
            if r.returncode == 0:
                print(f"FAIL (expected failure): {' '.join(a)}\n{r.stdout}")
                sys.exit(1)
            return r
        if r.returncode != 0:
            print(f"FAIL: {' '.join(a)}\n{r.stdout}\n{r.stderr}")
            sys.exit(1)
        print(f"  ok ({dt:5.1f} s)  {' '.join(a[:4])}", flush=True)
        return r

    def check(path, want, what):
        got = np.load(path)
        if not np.array_equal(got, want):
            print(f"FAIL: {what} not bit-exact")
            sys.exit(1)
        print(f"PASS  {what}: bit-exact", flush=True)

    # 1) gray MHV2 streamed both directions + streamed verify (end-bit)
    run("encode-video", str(tmp / "gray.npy"), str(tmp / "g.mhv2"),
        "--streaming", "--segment-frames", "3", "--frame-crcs",
        "--backend", "native")
    run("decode-video", str(tmp / "g.mhv2"), str(tmp / "g_out.npy"),
        "--streaming", *dev)
    check(tmp / "g_out.npy", gray, "gray MHV2 streamed roundtrip")
    run("verify", str(tmp / "g.mhv2"), "--streaming", *dev)
    print("PASS  gray MHV2 verify --streaming (end-bit per segment)",
          flush=True)

    # 2) corruption must fail the streamed chain
    bad = bytearray((tmp / "g.mhv2").read_bytes())
    from metalhuffman.models import frame_stream

    bad[frame_stream._trailer_offset(bytes(bad))] ^= 0x5A
    (tmp / "g_bad.mhv2").write_bytes(bytes(bad))
    run("verify", str(tmp / "g_bad.mhv2"), "--streaming",
        "--backend", "native", expect_fail=True)
    print("PASS  corrupted CRC fails streamed verify", flush=True)

    # 3) color (sub-green) streamed
    run("encode-video", str(tmp / "color.npy"), str(tmp / "c.mhtc"),
        "--streaming", "--color", "--subgreen", "--segment-frames", "2",
        "--backend", "native")
    run("decode-video", str(tmp / "c.mhtc"), str(tmp / "c_out.npy"),
        "--streaming", *dev)
    check(tmp / "c_out.npy", color, "MHTC color streamed roundtrip")

    # 4) u16 streamed
    run("encode-video", str(tmp / "u16.npy"), str(tmp / "u.mhtc"),
        "--streaming", "--gray16", "--segment-frames", "2",
        "--backend", "native")
    run("decode-video", str(tmp / "u.mhtc"), str(tmp / "u_out.npy"),
        "--streaming", *dev)
    check(tmp / "u_out.npy", u16, "MHTC u16 streamed roundtrip")

    # 5) temporal + motion, STREAMED ENCODE (round-5 trailer layout),
    #    device-fold streamed decode, streamed verify, checked random access
    run("encode-video", str(tmp / "gray.npy"), str(tmp / "t.mhvt"),
        "--streaming", "--temporal", "--motion", "--keyint", "4",
        "--frame-crcs", "--segment-frames", "3", "--backend", "native")
    run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_out.npy"),
        "--streaming", *dev)
    check(tmp / "t_out.npy", gray, "MHVT temporal+MC streamed roundtrip")
    run("verify", str(tmp / "t.mhvt"), "--streaming", *dev)
    print("PASS  MHVT verify --streaming (chained CRC + FCRC per chunk)",
          flush=True)
    n = t - 2
    run("decode-video", str(tmp / "t.mhvt"), str(tmp / "t_f.npy"),
        "--frame", str(n), "--check", *dev)
    check(tmp / "t_f.npy", gray[n], f"MHVT --frame {n} --check")

    # 6) MHTS streamed encode + streamed checked decode
    run("encode-video", str(tmp / "gray.npy"), str(tmp / "s.mhts"),
        "--streaming", "--per-frame-tables", "--backend", "native")
    run("decode-video", str(tmp / "s.mhts"), str(tmp / "s_out.npy"),
        "--streaming", "--check", *dev)
    check(tmp / "s_out.npy", gray, "MHTS streamed checked roundtrip")

    # 7) streamed resegment feeds the streamed verify
    run("resegment", str(tmp / "g.mhv2"), str(tmp / "g2.mhv2"),
        "--segment-frames", "2")
    run("verify", str(tmp / "g2.mhv2"), "--streaming", *dev)
    run("decode-video", str(tmp / "g2.mhv2"), str(tmp / "g2_out.npy"),
        "--streaming", *dev)
    check(tmp / "g2_out.npy", gray, "resegmented archive streamed decode")

    # 8) capture resume: append half the frames, then the rest — must be
    # byte-identical to the one-shot temporal capture (round-5 append)
    half = t // 2
    np.save(tmp / "h1.npy", gray[:half])
    np.save(tmp / "h2.npy", gray[half:])
    targs = ["--streaming", "--temporal", "--motion", "--keyint", "4",
             "--frame-crcs", "--segment-frames", str(half),
             "--backend", "native"]
    run("encode-video", str(tmp / "h1.npy"), str(tmp / "resume.mhvt"),
        *targs)
    run("encode-video", str(tmp / "h2.npy"), str(tmp / "resume.mhvt"),
        "--append", *targs)
    run("encode-video", str(tmp / "gray.npy"), str(tmp / "one.mhvt"),
        *targs)
    if (tmp / "resume.mhvt").read_bytes() != (tmp / "one.mhvt").read_bytes():
        print("FAIL: resumed capture != one-shot capture bytes")
        sys.exit(1)
    print("PASS  capture resume (--append): byte-identical to one-shot",
          flush=True)
    run("decode-video", str(tmp / "resume.mhvt"),
        str(tmp / "resume_out.npy"), "--streaming", *dev)
    check(tmp / "resume_out.npy", gray, "resumed capture streamed decode")

    print("\nSTREAMING GATE: ALL PASS "
          f"({'interpret/CPU' if args.interpret else 'GPU'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
