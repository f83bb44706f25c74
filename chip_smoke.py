"""GPU smoke run: drive the decode path once at full size, bit-exact.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --devices 4  # sharded decode on four GPUs only

Phases (single GPU):

1. platform: JAX's first device is a GPU; the card's name and power limit
   (``nvidia-smi``); the host codec is the compiled C++ library, not the
   NumPy fallback.
2. CLI: ``roundtrip``, then ``encode`` -> ``decode`` -> ``verify`` of the
   committed 2048x1536 photo, through ``cli.main`` in this process.
3. shared-table batch: 30 panned 2048x1536 frames encoded with one table,
   ``prepare_shared`` + ``decode_shared_step`` (raw image words and
   frames), the plain-XLA decode of the same batch, delta2d, 30 frames of
   1920x1080, and the checked decode (clean, then one flipped bit whose
   flags must equal the host oracle's).
4. video containers through the CLI: MHVT temporal+motion, MHTC color and
   gray16, and one ``--frame N --region`` request.
5. kernels: compile time, ``compiled.memory_analysis()`` and one
   steady-state time for the decode kernel (gray, delta2d, 1080p), the
   plain-XLA decode and the stage-1 encode packer.

Every output is compared bit for bit with the NumPy/C++ codec (the codec is
all-integer: the tolerance is zero). The last line of standard output is
one JSON object naming the device; it is printed only when every phase
passed. With no GPU, or without the rest of the repository beside this
file, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "tests", "assets", "bridge_2048x1536.png")
FRAMES = 30


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card(s)."""
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _equal(name: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        n = (int((got != want).sum()) if got.shape == want.shape
             else f"shape {got.shape} vs {want.shape}")
        raise AssertionError(f"{name}: not bit-exact ({n} differ)")


def _panned(img, frames: int, height: int, width: int):
    """``frames`` crops of ``img`` panned 8 px a frame (distinct bitstreams,
    photographic statistics)."""
    import numpy as np

    reps = (-(-height // img.shape[0]) + 1, -(-width // img.shape[1]) + 1)
    big = np.tile(img, reps)
    return np.stack([big[8 * t: 8 * t + height, 8 * t: 8 * t + width]
                     for t in range(frames)])


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def phase(self, name: str, fn) -> None:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # every failure is recorded and fails the run
            self.failed.append(name)
            print(f"FAIL  {name}\n{traceback.format_exc()}", flush=True)
            return
        print(f"PASS  {name} ({time.perf_counter() - t0:.1f} s)", flush=True)

    def timed(self, name: str, fn, args, nbytes: int):
        """Compile ``fn`` for ``args``; print compile time, memory analysis
        and a median steady-state time; return the output."""
        import jax
        import numpy as np

        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        t_compile = time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        ma = compiled.memory_analysis()
        print(f"  kernel {name}: compile {t_compile:.2f} s; "
              f"memory args={ma.argument_size_in_bytes} "
              f"out={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} B; "
              f"steady state {dt * 1e3:.3f} ms = {nbytes / dt / 1e9:.2f} GB/s "
              f"decoded bytes ({self.card}; median of 5, informative)",
              flush=True)
        return out


def _cli(*argv: str) -> None:
    from metalhuffman.cli import main

    rc = main(list(argv))
    if rc:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")


def single_gpu(smoke: Smoke, tmp: str) -> None:
    import jax.numpy as jnp
    import numpy as np

    from metalhuffman import native
    from metalhuffman.core import blocks, delta as delta_mod
    from metalhuffman.core.container import EncodedStream
    from metalhuffman.models import CodecConfig, frame_stream
    from metalhuffman.models.image_codec import decode_blocks_selection
    from metalhuffman.ops import decode_pallas, decode_xla, encode_device
    from metalhuffman.ops import layout as layout_mod
    from metalhuffman.utils import imageio

    img = imageio.load_grayscale(ASSET)

    def host_codec():
        name = native.backend_name()
        print(f"  host codec: {name}")
        if name != "native":
            raise RuntimeError("the C++ codec did not build")

    smoke.phase("platform: host codec", host_codec)

    def cli_image():
        mht = os.path.join(tmp, "bridge.mht")
        png = os.path.join(tmp, "bridge_out.png")
        _cli("roundtrip", ASSET)
        _cli("encode", ASSET, mht)
        _cli("decode", mht, png)
        _cli("verify", mht)
        _equal("CLI decode of the 2048x1536 photo", imageio.read_png(png), img)

    smoke.phase("CLI roundtrip, encode -> decode -> verify", cli_image)

    gray = _panned(img, FRAMES, 1536, 2048)
    cfg = CodecConfig(backend="pallas")
    state = {}

    def shared_batch():
        stream = frame_stream.encode_frames_shared(gray, cfg)
        state["stream"] = stream
        prep = frame_stream.prepare_shared(stream, FRAMES, 1536, 2048, cfg)
        raw = frame_stream.decode_shared_step(prep, cfg, raw=True)
        if raw.shape != (FRAMES, 1536, 512):
            raise AssertionError(f"raw words shape {raw.shape}")
        _equal("raw image words", frame_stream.frames_from_raw(
            raw, FRAMES, 1536, 2048), gray)
        _equal("frames", frame_stream.decode_shared_step(prep, cfg), gray)
        host = native.decode_blocks(stream, delta=True)
        _equal("C++ decode of the batch", host, np.concatenate(
            [blocks.image_to_blocks(f) for f in gray]))
        xcfg = CodecConfig(backend="xla")
        xprep = frame_stream.prepare_shared(stream, FRAMES, 1536, 2048, xcfg)
        _equal("plain-XLA decode", frame_stream.decode_shared_step(
            xprep, xcfg), gray)

    smoke.phase(f"shared-table batch {FRAMES}x2048x1536 (kernel, XLA, C++)",
                shared_batch)

    def delta2d():
        c2 = CodecConfig(backend="pallas", delta2d=True)
        s2 = frame_stream.encode_frames_shared(gray, c2)
        state["stream_d2"] = s2
        p2 = frame_stream.prepare_shared(s2, FRAMES, 1536, 2048, c2)
        _equal("delta2d raw words", frame_stream.frames_from_raw(
            frame_stream.decode_shared_step(p2, c2, raw=True), FRAMES, 1536,
            2048), gray)

    smoke.phase(f"delta2d {FRAMES}x2048x1536", delta2d)

    hd = _panned(img, FRAMES, 1080, 1920)

    def hd1080():
        s = frame_stream.encode_frames_shared(hd, cfg)
        state["stream_hd"] = s
        p = frame_stream.prepare_shared(s, FRAMES, 1080, 1920, cfg)
        _equal("1080p frames", frame_stream.decode_shared_step(p, cfg), hd)
        _equal("1080p raw words", frame_stream.frames_from_raw(
            frame_stream.decode_shared_step(p, cfg, raw=True), FRAMES, 1080,
            1920), hd)

    smoke.phase(f"1920x1080 x{FRAMES}", hd1080)

    def checked():
        stream = state["stream"]
        prep = frame_stream.prepare_shared(
            stream, FRAMES, 1536, 2048, cfg, check=True)
        out, err = frame_stream.decode_shared_step_checked(prep, cfg)
        _equal("checked decode", out, gray)
        if err.any():
            raise AssertionError(f"{int(err.sum())} clean blocks flagged")
        # one frame, one flipped bit: the device flags must equal the host
        # oracle's (native decode + re-encode of each block's bit count)
        view = frame_stream.frame_slice(stream, 0, 1, 1536, 2048, cfg)
        nb = view.block_offsets.size
        ncfg = CodecConfig(backend="native")
        for bit in range(int(view.block_offsets[1000]),
                         int(view.block_offsets[1000]) + 64):
            code = view.code_bytes.copy()
            code[bit >> 3] ^= 0x80 >> (bit & 7)
            bad = EncodedStream(view.num_symbols, view.widths, code,
                                view.block_offsets)
            _, host_err = decode_blocks_selection(
                bad, np.arange(nb), 1536, 2048, ncfg, check=True)
            if host_err.any():
                break
        else:
            raise AssertionError("no flip in block 1000 desyncs it")
        pb = frame_stream.prepare_shared(bad, 1, 1536, 2048, cfg, check=True)
        _, dev_err = frame_stream.decode_shared_step_checked(pb, cfg)
        _equal("flipped-bit flags vs host oracle", dev_err, host_err)
        print(f"  bit {bit} flipped: {int(dev_err.sum())} block(s) flagged, "
              f"first {int(np.flatnonzero(dev_err)[0])}")

    smoke.phase("checked decode: clean batch, one flipped bit", checked)

    def containers():
        g8 = gray[:8]
        np.save(os.path.join(tmp, "gray.npy"), g8)
        t = os.path.join(tmp, "t.mhvt")
        _cli("encode-video", os.path.join(tmp, "gray.npy"), t, "--temporal",
             "--motion", "--keyint", "4", "--frame-crcs")
        _cli("decode-video", t, os.path.join(tmp, "t.npy"))
        _equal("MHVT temporal+motion", np.load(os.path.join(tmp, "t.npy")),
               g8)
        last = len(g8) - 1  # the deepest frame of its keyframe group
        _cli("decode-video", t, os.path.join(tmp, "r.npy"), "--frame",
             str(last), "--region", "100", "200", "300", "400")
        _equal("MHVT --frame --region", np.load(os.path.join(tmp, "r.npy")),
               g8[last, 100:400, 200:600])
        rgb = np.stack([np.roll(g8[:4], 3 * c, axis=2) for c in range(3)],
                       axis=-1)
        np.save(os.path.join(tmp, "rgb.npy"), rgb)
        c = os.path.join(tmp, "c.mhtc")
        _cli("encode-video", os.path.join(tmp, "rgb.npy"), c, "--color")
        _cli("decode-video", c, os.path.join(tmp, "c.npy"))
        _equal("MHTC color", np.load(os.path.join(tmp, "c.npy")), rgb)
        u16 = ((g8[:4].astype(np.uint16) << 4) | (g8[:4] >> 4)).astype(
            np.uint16)
        np.save(os.path.join(tmp, "u16.npy"), u16)
        u = os.path.join(tmp, "u.mhtc")
        _cli("encode-video", os.path.join(tmp, "u16.npy"), u, "--gray16")
        _cli("decode-video", u, os.path.join(tmp, "u.npy"))
        _equal("MHTC gray16", np.load(os.path.join(tmp, "u.npy")), u16)

    smoke.phase("CLI video: MHVT temporal+motion, MHTC color/gray16, "
                "--frame --region", containers)

    def kernels():
        n = gray.size
        stream = state["stream"]
        w, o, t1, t2 = (jnp.asarray(a)
                        for a in decode_pallas.prepare_stream(stream))
        out = smoke.timed(
            "decode gray 30x2048x1536",
            lambda *a: decode_pallas.decode(*a, grid_bw=256), (w, o, t1, t2),
            n)
        _equal("kernel words", np.asarray(out).view(np.uint8).reshape(
            gray.shape), gray)
        s2 = state["stream_d2"]
        args2 = tuple(jnp.asarray(a) for a in decode_pallas.prepare_stream(s2))
        out = smoke.timed(
            "decode delta2d 30x2048x1536",
            lambda *a: decode_pallas.decode(*a, grid_bw=256, delta=False,
                                            delta2d=True), args2, n)
        _equal("kernel delta2d words", np.asarray(out).view(np.uint8).reshape(
            gray.shape), gray)
        sh = state["stream_hd"]
        argsh = tuple(jnp.asarray(a) for a in decode_pallas.prepare_stream(sh))
        out = smoke.timed(
            "decode gray 30x1920x1080",
            lambda *a: decode_pallas.decode(*a, grid_bw=240), argsh, hd.size)
        _equal("kernel 1080p words", np.asarray(out).view(np.uint8).reshape(
            hd.shape), hd)
        # the plain reference the kernel is compared with: decode_xla
        words, offs, wpr = decode_xla.prepare_stream(stream)

        def plain(words, offs, t1, t2):
            rows, bit_init = layout_mod.build_layout_jax(words, offs, wpr)
            return decode_xla.decode_blocks(rows, bit_init, t1, t2)

        blk = smoke.timed("plain XLA decode 30x2048x1536 (reference)", plain,
                          (jnp.asarray(words), jnp.asarray(offs), t1, t2), n)
        _equal("plain XLA blocks", blk, np.concatenate(
            [blocks.image_to_blocks(f) for f in gray]))
        # encode stage 1 (plain XLA) vs the C++ encoder
        syms = delta_mod.delta_encode_blocks(np.concatenate(
            [blocks.image_to_blocks(f) for f in gray])).reshape(-1, 64)
        widths = native.code_lengths(np.bincount(
            syms.reshape(-1), minlength=256).astype(np.int64))
        codes = native.canonical_codes(widths)
        bits_pb = widths[syms].astype(np.int64).sum(axis=1)
        wmax = int(bits_pb.max()) // 32 + 2
        lo, hi = encode_device.used_width_band(widths)
        rows = smoke.timed(
            "encode stage-1 packer 30x2048x1536",
            lambda s, c, wd: encode_device.pack_rows(
                s, c, wd, wmax=wmax, min_w=lo, max_w=hi),
            (jnp.asarray(syms), jnp.asarray(codes.astype(np.int32)),
             jnp.asarray(widths.astype(np.int32))), n)
        _equal("packer bit counts", np.asarray(rows)[:, wmax], bits_pb)
        code, offsets, _ = native.merge_rows(
            np.asarray(rows)[:, :wmax].view(np.uint32),
            bits_pb.astype(np.uint32))
        ref = native.encode_symbols(syms.reshape(-1), 64)
        _equal("hybrid encode bytes", code, ref.code_bytes)
        _equal("hybrid encode offsets", offsets, ref.block_offsets)

    smoke.phase("kernels: compile, memory, steady state", kernels)


def multi_gpu(smoke: Smoke, n_dev: int) -> None:
    import jax
    import numpy as np

    from metalhuffman.models import CodecConfig, frame_stream
    from metalhuffman.parallel import mesh as mesh_mod
    from metalhuffman.utils import imageio

    if len(jax.devices()) < n_dev:
        raise RuntimeError(
            f"--devices {n_dev}: JAX sees {len(jax.devices())} GPU(s)")
    gray = _panned(imageio.load_grayscale(ASSET), FRAMES, 1536, 2048)
    cfg = CodecConfig(backend="pallas")

    def spread(name, arr):
        devs = {s.device for s in arr.addressable_shards}
        print(f"  {name}: shards on {sorted(d.id for d in devs)}")
        if len(devs) != n_dev:
            raise AssertionError(f"{name} ran on {len(devs)} device(s)")

    def kernel_sharded():
        stream = frame_stream.encode_frames_shared(gray, cfg)
        single = frame_stream.decode_shared_step(
            frame_stream.prepare_shared(stream, FRAMES, 1536, 2048, cfg),
            cfg, raw=True)
        mesh = mesh_mod.make_mesh(n_dev)
        out = frame_stream.decode_shared_sharded(
            stream, FRAMES, 1536, 2048, mesh=mesh, config=cfg)
        spread("decode_shared_sharded", out)
        _equal("sharded vs single-GPU words", np.asarray(out).reshape(
            single.shape), single)
        _equal("sharded frames", frame_stream.frames_from_raw(
            out, FRAMES, 1536, 2048), gray)

    smoke.phase(f"decode_shared_sharded on {n_dev} GPUs", kernel_sharded)

    def frames_sharded():
        xcfg = CodecConfig(backend="xla")
        streams = frame_stream.encode_frames(gray[:8], xcfg)
        prep = frame_stream.prepare_batch(streams, 1536, 2048, xcfg)
        single = np.asarray(frame_stream.decode_batch(prep, xcfg))
        _equal("single-GPU batch decode", single, gray[:8])
        mesh = mesh_mod.make_mesh_2d(n_dev)
        out = frame_stream.decode_batch_sharded(prep, mesh=mesh, config=xcfg)
        spread("shard_decode.decode_frames_sharded", out)
        got = np.asarray(out)[:, : prep.n_blocks]
        from metalhuffman.core import blocks

        _equal("sharded batch vs single-GPU", np.stack(
            [blocks.blocks_to_image(b, 1536, 2048) for b in got]), single)

    smoke.phase(f"shard_decode.decode_frames_sharded on {n_dev} GPUs",
                frames_sharded)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4 = run only sharded decode across that many GPUs")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _fail(f"needs a GPU; JAX found {dev.platform!r} ({dev.device_kind})")
    sys.path.insert(0, HERE)
    try:
        from metalhuffman.utils import runtime
    except ImportError as e:
        _fail(f"the metalhuffman package is not beside this file ({e})")
    if not os.path.exists(ASSET):
        _fail(f"missing test asset {ASSET}")
    runtime.configure_compile_cache()

    card = _card()
    print(card, flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    smoke = Smoke(card)
    t0 = time.perf_counter()
    if args.devices > 1:
        multi_gpu(smoke, args.devices)
    else:
        scratch = runtime.cache_dir("smoke")
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            single_gpu(smoke, tmp)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failed:
        _fail(f"{len(smoke.failed)} phase(s) failed: {smoke.failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
