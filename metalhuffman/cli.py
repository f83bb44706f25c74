"""Command-line interface: encode / decode / roundtrip / info / bench.

The reference's L4 is a per-platform app shell whose configuration is edited
in source (``AAPLRenderer.m:726-744``); this framework's front door is this
CLI. Images are any PIL-supported format, raw ``.gray``, or ``.tga``;
containers are MHT1 (single frame) and MHTS (frame sequence).

    python -m metalhuffman encode photo.png out.mht
    python -m metalhuffman decode out.mht restored.png
    python -m metalhuffman roundtrip photo.png --backend pallas
    python -m metalhuffman info out.mht
    python -m metalhuffman bench --height 1536 --width 2048
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib
from pathlib import Path

import numpy as np


def _add_codec_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--block-dim", type=int, default=8)
    p.add_argument("--no-delta", action="store_true")
    p.add_argument("--zero-init", action="store_true",
                   help="zero-init-delta variant: block root bytes ship "
                        "uncoded in a side array (reference's "
                        "IMPL_DELTAS_AND_INIT_ZERO_DELTA mode)")
    p.add_argument("--delta2d", action="store_true",
                   help="2-D within-block predictor (row 0 delta-left, "
                        "rows below delta-up): ~3 entropy points smaller "
                        "than the raster delta on photos, still "
                        "block-parallel (beyond-reference mode)")
    p.add_argument(
        "--backend", default="pallas", choices=["pallas", "xla", "native"],
        help="decode path (pallas = the decode kernel, xla = plain XLA on "
             "the device, native = multithreaded host C++)",
    )
    p.add_argument("--interpret", action="store_true",
                   help="run JAX on the CPU: the decode kernel runs in the "
                        "Pallas interpreter (debugging without a GPU)")


def _config(args):
    from .models import CodecConfig

    return CodecConfig(
        block_dim=args.block_dim,
        delta=not args.no_delta,
        zero_init=getattr(args, "zero_init", False),
        delta2d=getattr(args, "delta2d", False),
        temporal=getattr(args, "temporal", False),
        keyint=getattr(args, "keyint", 8),
        motion=getattr(args, "motion", False),
        frame_crcs=getattr(args, "frame_crcs", False),
        backend=args.backend,
    )


def cmd_encode(args) -> int:
    from .models import ImageCodec, color
    from .utils import imageio

    if getattr(args, "gray16", False) and getattr(args, "color", False):
        raise SystemExit("--gray16 and --color are mutually exclusive")
    t0 = time.perf_counter()
    if getattr(args, "gray16", False):
        if getattr(args, "best", False) or getattr(args, "subgreen", False):
            raise SystemExit(
                "--best/--subgreen apply to u8 inputs, not --gray16")
        img = imageio.load_gray16(args.input)
        if img.ndim != 2:
            raise SystemExit(
                f"{args.input} is a {img.ndim}-D stack — use "
                "`encode-video --gray16` for (T, H, W) uint16 sequences")
        blob = color.encode_gray16_to_bytes(img, _config(args))
        kind = f"{img.shape[0]}x{img.shape[1]} u16"
        raw = img.size * 2
    elif getattr(args, "color", False):
        img = imageio.load_color(args.input)
        if getattr(args, "best", False):
            blob = color.encode_color_best(img, _config(args))
        else:
            cs = (color.CS_SUBGREEN if getattr(args, "subgreen", False)
                  else color.CS_IDENTITY)
            blob = color.encode_color_to_bytes(img, _config(args),
                                               colorspace=cs)
        kind = f"{img.shape[0]}x{img.shape[1]}x{img.shape[2]}"
        raw = img.size
    else:
        if getattr(args, "subgreen", False):
            raise SystemExit("--subgreen needs --color (it transforms "
                             "RGB channels)")
        img = imageio.load_grayscale(args.input)
        if getattr(args, "best", False):
            # grayscale --best: measure none/delta/delta2d, keep the
            # smallest (ImageCodec.encode_best)
            from .core import container as container_mod

            codec = ImageCodec(_config(args))
            stream, delta_used = codec.encode_best(img)
            blob = container_mod.write_frame(
                stream, img.shape[0], img.shape[1], codec.config.block_dim,
                delta_used,
                source_crc32=zlib.crc32(np.ascontiguousarray(img).tobytes()))
        else:
            blob = ImageCodec(_config(args)).encode_to_bytes(img)
        kind = f"{img.shape[0]}x{img.shape[1]}"
        raw = img.size
    dt = time.perf_counter() - t0
    Path(args.output).write_bytes(blob)
    print(
        f"{args.input}: {kind} -> {len(blob)} bytes "
        f"({len(blob)/raw:.1%}) in {dt*1e3:.1f} ms"
    )
    return 0


def cmd_decode(args) -> int:
    from .models import ImageCodec, color
    from .utils import imageio

    blob = Path(args.input).read_bytes()
    cfg = _config(args)
    t0 = time.perf_counter()
    if blob[:4] == b"MHVT":
        raise SystemExit(
            f"{args.input} is a temporal MHVT video container — use "
            "decode-video")
    if blob[:4] == color.COLOR_MAGIC:
        _, _c, layout, kind, _cs = color.unwrap(blob)
        if layout == color.LAYOUT_VIDEO:
            raise SystemExit(
                f"{args.input} is an MHTC video container — use decode-video")
        if kind == color.KIND_U16:
            img = color.decode_gray16_from_bytes(blob, cfg)
            dt = time.perf_counter() - t0
            imageio.save_gray16(img, args.output)
            shape = f"{img.shape[0]}x{img.shape[1]} u16"
        else:
            img = color.decode_color_from_bytes(blob, cfg)
            dt = time.perf_counter() - t0
            imageio.save_color(img, args.output)
            shape = f"{img.shape[0]}x{img.shape[1]}x{img.shape[2]}"
    else:
        img = ImageCodec(cfg).decode(blob)
        dt = time.perf_counter() - t0
        imageio.save_grayscale(img, args.output)
        shape = f"{img.shape[0]}x{img.shape[1]}"
    print(
        f"{args.input}: decoded {shape} "
        f"({args.backend}) in {dt*1e3:.1f} ms -> {args.output}"
    )
    return 0


def cmd_roundtrip(args) -> int:
    from .models import ImageCodec, color
    from .utils import imageio

    if getattr(args, "gray16", False):
        img = imageio.load_gray16(args.input)
        if img.ndim != 2:
            raise SystemExit("--gray16 roundtrip takes one (H, W) frame")
        cfg = _config(args)
        blob = color.encode_gray16_to_bytes(img, cfg)
        out = color.decode_gray16_from_bytes(blob, cfg)
        if not np.array_equal(out, img):
            raise SystemExit(f"{args.input}: gray16 roundtrip MISMATCH")
        print(
            f"{args.input}: {img.shape[0]}x{img.shape[1]} u16 bit-exact on "
            f"{args.backend}; {len(blob)} bytes "
            f"({len(blob)/(img.size*2):.1%})"
        )
        return 0
    if getattr(args, "color", False):
        img = imageio.load_color(args.input)
        cfg = _config(args)
        blob = color.encode_color_to_bytes(img, cfg)
        out = color.decode_color_from_bytes(blob, cfg)
        if not np.array_equal(out, img):
            raise SystemExit(f"{args.input}: color roundtrip MISMATCH")
        print(
            f"{args.input}: {img.shape[0]}x{img.shape[1]}x{img.shape[2]} "
            f"bit-exact on {args.backend}; {len(blob)} bytes "
            f"({len(blob)/img.size:.1%})"
        )
        return 0
    img = imageio.load_grayscale(args.input)
    codec = ImageCodec(_config(args))
    stream = codec.roundtrip_verify(img)
    print(
        f"{args.input}: {img.shape[0]}x{img.shape[1]} bit-exact on "
        f"{args.backend}; {stream.compressed_size} bytes "
        f"({stream.compressed_size/img.size:.1%}), "
        f"{stream.block_offsets.size} blocks"
    )
    return 0


def cmd_info(args) -> int:
    from .core import container
    from .models import color, frame_stream, temporal

    data = Path(args.input).read_bytes()
    if data[:4] == temporal.TEMPORAL_MAGIC:
        # describe each wrapper layer, then the inner stream
        print(temporal.describe(data))
        data = temporal.unwrap(data)[0]
    if data[:4] == color.COLOR_MAGIC:
        # describe the wrapper, then the inner plane stream on a second line
        print(color.describe(data))
        data = color.unwrap(data)[0]

    def pct(total: int, raw: int) -> str:
        return f" ({total/raw:.1%})" if raw else ""

    def mode_str(stream, delta) -> str:
        base = "delta2d" if stream.predictor == "2d" else str(delta)
        if stream.block_init is not None:
            return (base + "+zero-init") if stream.predictor == "2d" \
                else "zero-init"
        return base

    def crc_str(recorded, blob=None) -> str:
        out = f", crc32={'recorded' if recorded else 'absent'}"
        if blob is not None:
            try:
                fc = frame_stream.read_frame_crcs(blob)
            except ValueError:
                # info is the tool users reach for on DAMAGED files:
                # report the truncation instead of crashing
                return out + ", frame-crcs=TRUNCATED"
            if fc is not None:
                out += f", frame-crcs={fc.shape[0]}"
        return out

    if data[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(data)
        total = sum(s.compressed_size for s, _ in segs)
        per = ", ".join(f"{st}f/{s.compressed_size}B" for s, st in segs[:8])
        if len(segs) > 8:
            per += ", ..."
        mode = mode_str(segs[0][0], delta) if segs else str(delta)
        print(
            f"MHV2: {t} frames {h}x{w} in {len(segs)} shared-table segments, "
            f"block_dim={bd}, delta={mode}, {total} compressed bytes"
            f"{pct(total, t*h*w)}"
            f"{crc_str(frame_stream.source_crc32(data), data)} [{per}]"
        )
        return 0
    if data[:4] == frame_stream.SHARED_MAGIC:
        stream, t, h, w, bd, delta = frame_stream.read_shared(data)
        print(
            f"MHTV: {t} frames {h}x{w} shared-table, block_dim={bd}, "
            f"delta={mode_str(stream, delta)}, "
            f"{stream.compressed_size} compressed bytes"
            f"{pct(stream.compressed_size, t*h*w)}, "
            f"{stream.block_offsets.size} blocks"
            f"{crc_str(frame_stream.source_crc32(data), data)}"
        )
        return 0
    if data[:4] == frame_stream.STREAM_MAGIC:
        streams, h, w, bd, delta = frame_stream.read_stream(data)
        total = sum(s.compressed_size for s in streams)
        print(
            f"MHTS: {len(streams)} frames {h}x{w}, block_dim={bd}, "
            f"delta={mode_str(streams[0], delta)}, {total} compressed bytes"
            f"{pct(total, len(streams)*h*w)}"
            f"{crc_str(any(frame_stream.read_stream_crcs(data)))}"
        )
        return 0
    stream, h, w, bd, delta, crc = container.read_frame(data)
    widths = stream.widths
    active = int((widths > 0).sum())
    delta = mode_str(stream, delta)
    print(
        f"MHT1: {h}x{w}, block_dim={bd}, delta={delta}, "
        f"{stream.compressed_size} bytes{pct(stream.compressed_size, h*w)}, "
        f"{stream.block_offsets.size} blocks, {active} active symbols, "
        f"code widths {int(widths[widths>0].min())}..{int(widths.max())}, "
        f"crc32={'recorded' if crc else 'absent'}"
    )
    return 0


def _load_frames(path: str, color: bool = False) -> np.ndarray:
    """(T, H, W) uint8 frames — or (T, H, W, C) with ``color`` — from a .npy
    stack or a directory of image files."""
    from .utils import imageio

    p = Path(path)
    if p.is_dir():
        files = sorted(
            f for f in p.iterdir()
            if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".gray", ".tga")
        )
        if not files:
            raise SystemExit(f"no image files in {path}")
        load = imageio.load_color if color else imageio.load_grayscale
        return np.stack([load(f) for f in files])
    frames = np.load(p)
    want = 4 if color else 3
    if frames.ndim != want or frames.dtype != np.uint8:
        shape = "(T, H, W, C)" if color else "(T, H, W)"
        raise SystemExit(f".npy input must be a {shape} uint8 array")
    return frames


def _pick_best_precoder(frames: np.ndarray, cfg):
    """Measure none/delta/delta2d on the real payload; keep the smallest.

    The video analog of ``ImageCodec.encode_best``; encode is host-cheap.
    """
    import dataclasses

    from .models import frame_stream

    candidates = [
        dataclasses.replace(cfg, delta=False, delta2d=False, zero_init=False),
        dataclasses.replace(cfg, delta=True, delta2d=False),
        dataclasses.replace(cfg, delta=True, delta2d=True),
    ]

    def total_size(c):
        return sum(
            s.compressed_size
            for s, _ in frame_stream.encode_frames_segmented(frames, c))

    best = min(candidates, key=total_size)
    mode = "delta2d" if best.delta2d else "delta" if best.delta else "none"
    print(f"--best picked precoder: {mode}", file=sys.stderr)
    return best


def _cmd_encode_video_streaming(args) -> int:
    """encode-video --streaming: memory-bounded push-frame encode.

    The input is consumed incrementally (an .npy stack is memory-mapped, a
    directory is loaded one image at a time) and segments are written as
    soon as their frames are buffered — peak memory is one segment of raw
    frames, independent of video length. Grayscale writes MHV2 directly;
    --color/--gray16 write MHTC wrapping a streamed inner MHV2 (the MHTC
    header is fixed-size, so it composes). Output is always (inner) MHV2 —
    the segment count is only known at the end; every decode surface
    treats a 1-segment MHV2 exactly like MHTV.
    """
    from .models import color as color_mod
    from .models.stream_writer import (ColorStreamingEncoder,
                                       MHTSStreamingEncoder,
                                       StreamingEncoder,
                                       TemporalStreamingEncoder)
    from .utils import imageio

    for flag, what in [("best", "--best"), ("best_fast", "--best-fast")]:
        if getattr(args, flag, False):
            raise SystemExit(
                f"--streaming writes containers incrementally; "
                f"{what} needs the full sequence in memory — drop one")
    appending = getattr(args, "append", False)
    if appending and not Path(args.output).exists():
        raise SystemExit(
            f"--append resumes an existing container, but {args.output} "
            "does not exist (drop --append for a fresh capture)")
    if getattr(args, "motion", False) and not getattr(args, "temporal",
                                                      False):
        raise SystemExit("--motion requires --temporal")
    is_color = getattr(args, "color", False)
    is_u16 = getattr(args, "gray16", False)
    mhts = getattr(args, "per_frame_tables", False)
    if is_color and is_u16:
        raise SystemExit("--gray16 and --color are mutually exclusive")
    if mhts:
        if getattr(args, "temporal", False):
            raise SystemExit(
                "--temporal writes a shared-table MHVT container; drop "
                "--per-frame-tables")
        if is_color or is_u16:
            raise SystemExit(
                "--per-frame-tables applies to grayscale MHTS output only "
                "(MHTC planes share one canonical table)")
        if args.segment_frames is not None:
            raise SystemExit(
                "MHTS has no segments (every frame is self-contained); "
                "drop --segment-frames")
    if args.segment_frames is not None and args.segment_frames < 1:
        raise SystemExit("--segment-frames must be >= 1")
    if getattr(args, "subgreen", False) and not is_color:
        raise SystemExit("--subgreen needs --color")
    cfg = _config(args)
    t0 = time.perf_counter()
    p = Path(args.input)

    def make(h, w, channels=None, u16=False, colorspace=None):
        """The writer for this geometry/kind: MHTS when --per-frame-tables,
        MHVT (trailer layout) when --temporal, else the bare MHV2/MHTC
        writer."""
        if mhts:
            return MHTSStreamingEncoder(args.output, h, w, cfg,
                                        append=appending)
        if cfg.temporal:
            return TemporalStreamingEncoder(
                args.output, h, w, cfg, channels=channels, u16=u16,
                colorspace=colorspace,
                max_segment_frames=args.segment_frames,
                frame_crcs=cfg.frame_crcs, append=appending)
        if u16:
            return ColorStreamingEncoder(
                args.output, h, w, u16=True, config=cfg,
                max_segment_frames=args.segment_frames,
                frame_crcs=cfg.frame_crcs, append=appending)
        if channels is not None:
            return ColorStreamingEncoder(
                args.output, h, w, channels=channels, config=cfg,
                colorspace=colorspace,
                max_segment_frames=args.segment_frames,
                frame_crcs=cfg.frame_crcs, append=appending)
        return StreamingEncoder(
            args.output, h, w, cfg,
            max_segment_frames=args.segment_frames,
            frame_crcs=cfg.frame_crcs, append=appending)

    def drive(make_enc, chunks, first=None):
        try:
            with make_enc() as enc:
                if first is not None:
                    enc.push(first)
                for c in chunks:
                    enc.push(c)
        except ValueError as e:
            # writer validation (append mismatches, geometry, torn
            # inputs) becomes a clean CLI message, not a traceback
            raise SystemExit(str(e))
        return enc.stats

    if is_u16:
        if p.is_dir():
            raise SystemExit(
                "--gray16 video input must be a (T, H, W) uint16 .npy stack")
        frames = np.load(p, mmap_mode="r")
        if frames.ndim != 3 or frames.dtype != np.uint16:
            raise SystemExit(
                "--gray16 video input must be a (T, H, W) uint16 .npy stack")
        t, h, w = frames.shape
        stats = drive(
            lambda: make(h, w, u16=True),
            (np.ascontiguousarray(frames[a : a + 16])
             for a in range(0, t, 16)))
        kind, bpp = "MHTC[u16", 2
    elif is_color:
        cs = (color_mod.CS_SUBGREEN if getattr(args, "subgreen", False)
              else color_mod.CS_IDENTITY)
        if p.is_dir():
            files = sorted(
                f for f in p.iterdir()
                if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tga"))
            if not files:
                raise SystemExit(f"no image files in {args.input}")
            first = imageio.load_color(files[0])
            h, w, ch = first.shape
            stats = drive(
                lambda: make(h, w, channels=ch, colorspace=cs),
                (imageio.load_color(f) for f in files[1:]), first=first)
        else:
            frames = np.load(p, mmap_mode="r")
            if frames.ndim != 4 or frames.dtype != np.uint8:
                raise SystemExit(
                    ".npy input must be a (T, H, W, C) uint8 array")
            t, h, w, ch = frames.shape
            stats = drive(
                lambda: make(h, w, channels=ch, colorspace=cs),
                (np.ascontiguousarray(frames[a : a + 16])
                 for a in range(0, t, 16)))
        kind, bpp = f"MHTC[{ch}ch", ch
    else:
        if p.is_dir():
            files = sorted(
                f for f in p.iterdir()
                if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".gray",
                                        ".tga"))
            if not files:
                raise SystemExit(f"no image files in {args.input}")
            first = imageio.load_grayscale(files[0])
            h, w = first.shape
            stats = drive(
                lambda: make(h, w),
                (imageio.load_grayscale(f) for f in files[1:]), first=first)
        else:
            frames = np.load(p, mmap_mode="r")
            if frames.ndim != 3 or frames.dtype != np.uint8:
                raise SystemExit(
                    ".npy input must be a (T, H, W) uint8 array")
            t, h, w = frames.shape
            stats = drive(
                lambda: make(h, w),
                (np.ascontiguousarray(frames[a : a + 64])
                 for a in range(0, t, 64)))
        kind, bpp = ("MHTS[per-frame" if mhts else "MHV2[plain"), 1
    dt = time.perf_counter() - t0
    raw = stats.total_frames * h * w * bpp
    if cfg.temporal:
        mc = ", motion" if cfg.motion else ""
        kind = f"MHVT[keyint {cfg.keyint}{mc}]/" + kind
    if appending:
        kind += ", appended"
    print(
        f"{args.input}: {stats.total_frames} frames {h}x{w} -> "
        f"{kind}, {stats.num_segments} segments, streamed] "
        f"{stats.bytes_written} bytes ({stats.bytes_written/raw:.1%}) "
        f"in {dt:.2f} s"
    )
    return 0


def cmd_encode_video(args) -> int:
    from .models import frame_stream

    if getattr(args, "streaming", False):
        return _cmd_encode_video_streaming(args)
    if getattr(args, "segment_frames", None) is not None:
        raise SystemExit("--segment-frames requires --streaming")
    if getattr(args, "append", False):
        raise SystemExit("--append requires --streaming")
    if getattr(args, "motion", False) and not getattr(args, "temporal", False):
        raise SystemExit("--motion requires --temporal")
    if getattr(args, "gray16", False) or getattr(args, "color", False):
        # MHTC containers are always shared-table inside; other encode
        # shaping flags do not apply — refuse rather than silently ignore
        if getattr(args, "gray16", False) and getattr(args, "color", False):
            raise SystemExit("--gray16 and --color are mutually exclusive")
        if args.per_frame_tables:
            raise SystemExit(
                "--per-frame-tables applies to grayscale MHTS output only "
                "(MHTC planes share one canonical table)")
        if getattr(args, "gray16", False) and (
                getattr(args, "best", False)
                or getattr(args, "subgreen", False)):
            raise SystemExit(
                "--best/--subgreen apply to u8 color input, not --gray16")
        if getattr(args, "best_fast", False):
            raise SystemExit(
                "--best-fast searches grayscale temporal candidates; for "
                "--color/--gray16 use --best (full measurement)")
    if getattr(args, "gray16", False):
        from .models import color as color_mod

        frames = np.load(Path(args.input))
        if frames.ndim != 3 or frames.dtype != np.uint16:
            raise SystemExit(
                "--gray16 video input must be a (T, H, W) uint16 .npy stack")
        t, h, w = frames.shape
        t0 = time.perf_counter()
        cfg = _config(args)
        if cfg.temporal:
            from .models import temporal

            blob = temporal.encode_temporal_gray16_video(frames, cfg)
            kind = f"MHVT[keyint {cfg.keyint}]/MHTC"
        else:
            blob = color_mod.encode_gray16_to_bytes(frames, cfg)
            kind = "MHTC"
        dt = time.perf_counter() - t0
        Path(args.output).write_bytes(blob)
        print(
            f"{args.input}: {t} frames {h}x{w} u16 -> {kind} {len(blob)} "
            f"bytes ({len(blob)/(frames.size*2):.1%}) in {dt:.2f} s"
        )
        return 0
    if getattr(args, "color", False):
        from .models import color as color_mod

        frames = _load_frames(args.input, color=True)
        t, h, w, c = frames.shape
        t0 = time.perf_counter()
        cfg = _config(args)
        cs = (color_mod.CS_SUBGREEN if getattr(args, "subgreen", False)
              else color_mod.CS_IDENTITY)
        mvs = None
        if getattr(args, "best", False):
            # precoder selection runs on the actual plane stack (the payload
            # the inner container carries, after temporal prediction — with
            # the same motion compensation the real encode applies — and any
            # colorspace transform, in the encoder's order)
            src = frames
            if cfg.temporal:
                from .models import temporal

                if cfg.motion:
                    src, mvs = temporal.temporal_encode_mc(src, cfg.keyint)
                else:
                    src = temporal.temporal_encode(src, cfg.keyint)
            src = color_mod.to_subgreen(src) if cs else src
            planes = src.transpose(0, 3, 1, 2).reshape(t * c, h, w)
            cfg = _pick_best_precoder(planes, cfg)
        if cfg.temporal:
            from .models import temporal

            # mvs (when --best already estimated them) are reused verbatim
            blob = temporal.encode_temporal_color_video(frames, cfg,
                                                        colorspace=cs,
                                                        mvs=mvs)
            kind = f"MHVT[keyint {cfg.keyint}]/MHTC"
        else:
            blob = color_mod.encode_color_video_to_bytes(frames, cfg,
                                                         colorspace=cs)
            kind = "MHTC"
        dt = time.perf_counter() - t0
        Path(args.output).write_bytes(blob)
        print(
            f"{args.input}: {t} frames {h}x{w}x{c} -> {kind} {len(blob)} "
            f"bytes ({len(blob)/frames.size:.1%}) in {dt:.2f} s"
        )
        return 0
    frames = _load_frames(args.input)
    t, h, w = frames.shape
    cfg = _config(args)
    if cfg.temporal and args.per_frame_tables:
        raise SystemExit(
            "--temporal writes a shared-table MHVT container; drop "
            "--per-frame-tables")
    t0 = time.perf_counter()
    if getattr(args, "best_fast", False) and not cfg.temporal:
        raise SystemExit("--best-fast searches temporal candidates; add "
                         "--temporal (and optionally --motion)")
    if (getattr(args, "best", False) or getattr(args, "best_fast", False)) \
            and cfg.temporal:
        # temporal is content-dependent like sub-green (wins on static
        # scenes, loses on global motion) — measure temporal vs plain,
        # each with its best spatial precoder on its own payload;
        # --best-fast ranks candidates on a frame subsample and fully
        # encodes only the two best (>= 5x less work on long inputs)
        from .models import temporal

        search = (temporal.encode_video_best_fast
                  if getattr(args, "best_fast", False)
                  else temporal.encode_video_best)
        blob, kind, used = search(frames, cfg)
        dt = time.perf_counter() - t0
        Path(args.output).write_bytes(blob)
        mode = ("delta2d" if used.delta2d else
                "delta" if used.delta else "none")
        kept = (f"MHVT[keyint {cfg.keyint}, {kind}]" if kind != "plain"
                else "plain (temporal measured larger)")
        print(f"--best picked: {kept}, precoder {mode}", file=sys.stderr)
        print(
            f"{args.input}: {t} frames {h}x{w} -> "
            f"{blob[:4].decode('ascii', 'replace')} {len(blob)} bytes "
            f"({len(blob)/frames.size:.1%}) in {dt:.2f} s"
        )
        return 0
    if getattr(args, "best", False):
        cfg = _pick_best_precoder(frames, cfg)
    if cfg.temporal:
        from .models import temporal

        blob = temporal.encode_temporal_video(frames, cfg)
        dt = time.perf_counter() - t0
        Path(args.output).write_bytes(blob)
        print(
            f"{args.input}: {t} frames {h}x{w} -> MHVT[keyint {cfg.keyint}] "
            f"{len(blob)} bytes ({len(blob)/frames.size:.1%}) in {dt:.2f} s"
        )
        return 0
    if args.per_frame_tables:
        streams = frame_stream.encode_frames(frames, cfg)
        blob = frame_stream.write_stream(
            streams, h, w, cfg,
            source_crc32s=[zlib.crc32(np.ascontiguousarray(f).tobytes())
                           for f in frames])
        kind = "MHTS"
    else:
        # auto-upgrades to segmented MHV2 when one shared stream could
        # overflow the u32 block-offset index (> ~512 MB compressed)
        crc = zlib.crc32(np.ascontiguousarray(frames).tobytes())
        fcrcs = (frame_stream.compute_frame_crcs(frames)
                 if cfg.frame_crcs else None)
        segs = frame_stream.encode_frames_segmented(frames, cfg)
        if len(segs) == 1:
            blob = frame_stream.write_shared(
                segs[0][0], t, h, w, cfg, source_crc32=crc,
                frame_crcs=fcrcs)
            kind = "MHTV"
        else:
            blob = frame_stream.write_segmented(
                segs, h, w, cfg, source_crc32=crc, frame_crcs=fcrcs)
            kind = f"MHV2[{len(segs)} segments]"
    dt = time.perf_counter() - t0
    Path(args.output).write_bytes(blob)
    print(
        f"{args.input}: {t} frames {h}x{w} -> {kind} {len(blob)} bytes "
        f"({len(blob)/frames.size:.1%}) in {dt:.2f} s"
    )
    return 0


def _decode_video_frames(data: bytes, cfg, check: bool,
                         salvage: bool = False):
    """Decode any MHTV/MHV2/MHTS container -> (frames, t, h, w, n_corrupt).

    ``check=True`` runs the on-device per-block end-bit integrity check
    (Pallas backend only) and raises SystemExit naming the corrupt blocks;
    with ``salvage=True`` corrupt blocks are zero-filled instead and their
    count returned (best-effort serving decode — a stream consumer would
    rather show black squares than drop the batch). Shared by
    ``decode-video`` and ``verify``.
    """
    from .models import frame_stream

    import dataclasses

    n_corrupt = 0

    def handle_err(frames, err, where=""):
        nonlocal n_corrupt
        if not err.any():
            return frames
        idx = np.nonzero(err)[0]
        if salvage:
            frames, n = frame_stream.salvage_blocks(frames, err,
                                                    cfg.block_dim)
            n_corrupt += n
            print(f"salvaged {idx.size} corrupt block(s){where}, first at "
                  f"{idx[:8].tolist()} (zero-filled)", file=sys.stderr)
            return frames
        raise SystemExit(
            f"stream integrity check failed{where}: {idx.size} corrupt "
            f"block(s), first at {idx[:8].tolist()}")

    if data[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(data)
        cfg = dataclasses.replace(
            cfg, block_dim=bd, delta=delta,
            delta2d=bool(segs) and segs[0][0].predictor == "2d")
        if check:
            # per-segment checked decode with salvage support
            outs = []
            for si, fr, err in frame_stream.iter_frames_segmented_checked(
                    segs, h, w, cfg):
                outs.append(handle_err(fr, err, f" in segment {si}"))
            frames = np.concatenate(outs)
        else:
            try:
                frames = frame_stream.decode_frames_segmented(
                    segs, h, w, cfg, check=False)
            except ValueError as e:
                raise SystemExit(str(e))
    elif data[:4] == frame_stream.SHARED_MAGIC:
        stream, t, h, w, bd, delta = frame_stream.read_shared(data)
        # the container header is authoritative for block_dim/delta/mode
        cfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                  delta2d=stream.predictor == "2d")
        if cfg.backend == "native":
            # host decode (one segment) — never touches a device
            frames = frame_stream.decode_frames_segmented(
                [(stream, t)], h, w, cfg)
        elif check:
            # on-device integrity check: each block must end at its indexed
            # bit position (kernel emits the end-bit carry for free)
            prep = frame_stream.prepare_shared(stream, t, h, w, cfg,
                                               check=True)
            frames, err = frame_stream.decode_shared_step_checked(prep, cfg)
            frames = handle_err(np.asarray(frames), err)
        else:
            frames = np.asarray(
                frame_stream.decode_frames_shared(stream, t, h, w, cfg))
    elif data[:4] == frame_stream.STREAM_MAGIC:
        streams, h, w, bd, delta = frame_stream.read_stream(data)
        cfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                  delta2d=streams[0].predictor == "2d")
        mixed = len({s.predictor for s in streams}) > 1
        if mixed and cfg.backend == "xla":
            # batched decode needs one static predictor; decode per frame
            cfg = dataclasses.replace(cfg, backend="pallas")
        if check:
            # per-frame checked decode (a one-frame batch is a shared
            # stream); serial — the check's host fetch is a barrier
            frames = []
            for fi, s in enumerate(streams):
                fcfg = dataclasses.replace(cfg,
                                           delta2d=s.predictor == "2d")
                prep = frame_stream.prepare_shared(s, 1, h, w, fcfg,
                                                   check=True)
                img, err = frame_stream.decode_shared_step_checked(prep, fcfg)
                img = handle_err(np.asarray(img).reshape(1, h, w), err,
                                 f" in frame {fi}")
                frames.append(img.reshape(h, w))
            frames = np.stack(frames)
        elif cfg.backend == "xla":
            prep = frame_stream.prepare_batch(streams, h, w, cfg)
            frames = np.asarray(frame_stream.decode_batch(prep, cfg))
        else:
            # per-frame tables -> per-frame kernel dispatches (the batched
            # path above is plain XLA)
            from .models import ImageCodec

            def one(s):
                codec = ImageCodec(dataclasses.replace(
                    cfg, delta2d=s.predictor == "2d"))
                return np.asarray(codec.decode_step(codec.prepare(s, h, w)))

            frames = np.stack([one(s) for s in streams])
        t = len(streams)
    else:
        raise SystemExit("not an MHTV/MHV2/MHTS container")
    return frames, t, h, w, n_corrupt


def _verify_video_crc(data: bytes, frames) -> bool:
    """Check decoded frames against any recorded source CRC-32.

    Returns True when a CRC was recorded and matched, False when the
    container records none; raises SystemExit on mismatch. This catches
    length-preserving corruption the on-device end-bit check cannot see
    (same-width code substitutions).
    """
    from .models import frame_stream

    try:
        if data[:4] == frame_stream.STREAM_MAGIC:
            crcs = frame_stream.read_stream_crcs(data)
            for fi, (f, crc) in enumerate(zip(frames, crcs)):
                if crc and zlib.crc32(
                        np.ascontiguousarray(f).tobytes()) != crc:
                    raise ValueError(
                        f"decoded frame {fi} fails its recorded CRC-32 — "
                        "the stream is corrupt")
            return any(crcs)
        recorded = frame_stream.source_crc32(data)
        frame_stream.verify_source_crc32(np.asarray(frames), recorded)
        return bool(recorded)
    except ValueError as e:
        raise SystemExit(str(e))


def _decode_one_frame(data: bytes, cfg, n: int):
    """Random-access decode of frame ``n`` from any video container.

    Only that frame's blocks are decoded — temporal random access via the
    per-block offset index (``frame_stream.decode_frame``). Returns
    (img, h, w).
    """
    import dataclasses

    from .models import frame_stream

    def bad(total):
        raise SystemExit(f"--frame {n} out of range (container has {total})")

    if data[:4] in (frame_stream.SHARED_MAGIC, frame_stream.SEGMENTED_MAGIC):
        try:
            frames, h, w = frame_stream.decode_range(data, n, n + 1, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        return frames.reshape(h, w), h, w
    if data[:4] == frame_stream.STREAM_MAGIC:
        streams, h, w, bd, delta = frame_stream.read_stream(data)
        if not 0 <= n < len(streams):
            bad(len(streams))
        cfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                  delta2d=streams[n].predictor == "2d")
        img = frame_stream.decode_frame(streams[n], 0, h, w, cfg)
        crc = frame_stream.read_stream_crcs(data)[n]
        if crc and zlib.crc32(np.ascontiguousarray(img).tobytes()) != crc:
            raise SystemExit(
                f"frame {n} fails its recorded CRC-32 — the stream is corrupt")
        return img, h, w
    raise SystemExit("not an MHTV/MHV2/MHTS container")


def _save_frame(img: np.ndarray, out: Path) -> None:
    """Save one decoded frame, picking the writer by dtype/shape."""
    from .models import color  # noqa: F401  (kind constants documented)
    from .utils import imageio

    if out.suffix == ".npy":
        np.save(out, img)
    elif img.dtype == np.uint16:
        imageio.save_gray16(img, out)
    elif img.ndim == 3:
        imageio.save_color(img, out)
    else:
        imageio.save_grayscale(np.asarray(img), out)


def _cmd_decode_video_temporal(args, data: bytes, cfg, check: bool,
                               salvage: bool = False) -> int:
    """decode-video on an MHVT container: full decode, --frame, --check.

    Every device-side check (end-bit, inner CRC) runs on the residual
    stream exactly as for a plain container; the temporal fold happens on
    the reconstructed host array and the outer CRC pins the result.
    """
    from .models import color, temporal

    inner, keyint, tcrc, mvs, fcrcs, first_len = temporal.unwrap(data)
    if getattr(args, "frames", None) is not None:
        if check:
            raise SystemExit(
                "--check verifies whole streams; --frames range access "
                "verifies any recorded per-frame CRCs automatically")
        a, b = args.frames
        t0 = time.perf_counter()
        try:
            frames = temporal.decode_temporal_range(data, a, b, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        dt = time.perf_counter() - t0
        out = Path(args.output)
        if out.suffix == ".npy":
            np.save(out, frames)
        else:
            out.mkdir(parents=True, exist_ok=True)
            for i, f in enumerate(frames):
                _save_frame(f, out / f"frame_{a + i:05d}.png")
        checked = ", frame CRCs ok" if fcrcs is not None else ""
        print(f"{args.input}: decoded frames [{a}, {b}) (keyint {keyint}"
              f"{checked}) in {dt:.3f} s -> {args.output}")
        return 0
    if getattr(args, "frame", None) is not None:
        # --frame --check verifies via the per-frame CRC table (flag bit 1)
        # — decode_temporal_frame checks it automatically whenever present;
        # --check just insists the container actually records one
        if check and fcrcs is None:
            raise SystemExit(
                "--frame --check needs a per-frame CRC table; this "
                "container records none (encode with --frame-crcs), so "
                "only whole-stream verification is possible (`verify`)")
        t0 = time.perf_counter()
        try:
            img = temporal.decode_temporal_frame(data, args.frame, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        dt = time.perf_counter() - t0
        _save_frame(img, Path(args.output))
        h, w = img.shape[:2]
        checked = ", frame CRC ok" if fcrcs is not None else ""
        print(f"{args.input}: decoded frame {args.frame} ({h}x{w}, "
              f"keyint {keyint}{checked}) in {dt:.3f} s -> {args.output}")
        return 0
    if check and args.backend != "pallas":
        raise SystemExit(
            "--check requires --backend pallas (the on-device integrity "
            "check is emitted by the decode kernel)")
    t0 = time.perf_counter()
    if not check:
        # production path: decode AND temporal fold on device, one fetch;
        # decode_temporal_video verifies the outer CRC (and falls back to
        # the dual-CRC host path to localize any corruption)
        try:
            frames = temporal.decode_temporal_video(data, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        h, w = frames.shape[1], frames.shape[2]
    else:
        # --check decodes the RESIDUAL stream with the on-device end-bit
        # check, so the fold runs on the fetched residuals afterwards
        if inner[:4] == color.COLOR_MAGIC:
            inner2, channels, layout, kind, cs = color.unwrap(inner)
            if layout != color.LAYOUT_VIDEO:
                raise SystemExit("MHVT inner MHTC container is not a video")
            planes, _n, h, w, bad = _decode_video_frames(
                inner2, cfg, check, salvage)
            if not bad:
                _verify_video_crc(inner2, planes)
            res = color.fold_video_planes(np.asarray(planes), channels,
                                          kind, cs)
        else:
            res, _t, h, w, bad = _decode_video_frames(inner, cfg, check,
                                                      salvage)
            if not bad:
                _verify_video_crc(inner, res)
            res = np.asarray(res)
        try:
            frames = (temporal.temporal_decode_mc(res, keyint, mvs,
                                                  first_len=first_len)
                      if mvs is not None
                      else temporal.temporal_decode(res, keyint,
                                                    first_len=first_len))
        except ValueError as e:  # e.g. truncated/corrupt motion table
            raise SystemExit(str(e))
        if bad:
            print("salvaged output: CRC checks skipped "
                  f"({bad} zero-filled block(s) in the residual stream)",
                  file=sys.stderr)
        elif tcrc and zlib.crc32(
                np.ascontiguousarray(frames).tobytes()) != tcrc:
            raise SystemExit(
                "reconstructed frames fail the MHVT source CRC-32 — corrupt "
                "container")
    t = frames.shape[0]
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".npy":
        np.save(out, frames)
    else:
        out.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            _save_frame(f, out / f"frame_{i:05d}.png")
    print(f"{args.input}: decoded {t} frames {h}x{w} (temporal, keyint "
          f"{keyint}) in {dt:.2f} s -> {args.output}")
    return 0


def _frame_span(args, total: int):
    """Frame range selected by --frame / --frames (default: all frames)."""
    if args.frame is not None:
        return args.frame, args.frame + 1
    fr = getattr(args, "frames", None)
    if fr is not None:
        return fr[0], fr[1]
    return 0, total


def _cmd_decode_video_region(args, data: bytes, cfg) -> int:
    """decode-video --region [--frame N | --frames A B]: ROI decode."""
    import struct as struct_mod

    from .models import color, frame_stream, temporal

    y0, x0, rhh, rww = args.region
    check = getattr(args, "check", False)
    if getattr(args, "salvage", False):
        raise SystemExit(
            "--salvage applies to whole-stream decode; --region --check "
            "fails fast on the touched blocks instead")
    if args.frame is not None and getattr(args, "frames", None) is not None:
        raise SystemExit("--frame and --frames are mutually exclusive")
    t0 = time.perf_counter()
    check_how = "end-bit integrity check"
    try:
        if data[:4] == temporal.TEMPORAL_MAGIC:
            parts = temporal.unwrap(data)
            total = temporal._inner_frame_count(parts[0])
            if total is None:
                raise SystemExit(
                    "corrupt MHVT container (unrecognized inner stream)")
            if parts[3] is not None:  # motion: the MC fallback verifies
                check_how = "frame-CRC check"  # via the per-frame table
            a, b = _frame_span(args, total)
            out = temporal.decode_temporal_video_region(
                data, a, b, y0, x0, rhh, rww, cfg, check=check)
        elif data[:4] == color.COLOR_MAGIC:
            inner, ch, layout, kind, _cs = color.unwrap(data)
            if layout != color.LAYOUT_VIDEO:
                raise SystemExit("--region needs a video container; use "
                                 "the library decode_region for images")
            (planes,) = struct_mod.unpack_from("<I", inner, 4)
            total = planes // (2 if kind == color.KIND_U16 else ch)
            a, b = _frame_span(args, total)
            out = color.decode_color_video_region(
                data, a, b, y0, x0, rhh, rww, cfg, check=check)
        elif data[:4] in (frame_stream.SHARED_MAGIC,
                          frame_stream.SEGMENTED_MAGIC,
                          frame_stream.STREAM_MAGIC):
            (total,) = struct_mod.unpack_from("<I", data, 4)
            a, b = _frame_span(args, total)
            out = frame_stream.decode_video_region(
                data, a, b, y0, x0, rhh, rww, cfg, check=check)
        else:
            raise SystemExit(
                "--region supports MHTV/MHV2/MHTS/MHTC/MHVT containers")
    except ValueError as e:
        raise SystemExit(str(e))
    dt = time.perf_counter() - t0
    outp = Path(args.output)
    if args.frame is not None:
        _save_frame(out[0], outp)
    elif outp.suffix == ".npy":
        np.save(outp, out)
    else:
        outp.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(out):
            _save_frame(f, outp / f"frame_{i:05d}.png")
    which = (f"frame {args.frame}" if args.frame is not None
             else f"frames [{a}, {b})")
    checked = f" ({check_how}: ok)" if check else ""
    print(f"{args.input}: decoded {rhh}x{rww} region at ({y0}, {x0}) of "
          f"{which} in {dt:.3f} s{checked} -> {args.output}")
    return 0


def _streamed_sink(out: Path, total: int, h: int, w: int, channels: int,
                   kind: int):
    """Output sink for a streaming decode: ``(npy, sink_or_None, save)``.

    One shape/dtype/saver selection shared by the plain and temporal
    streaming commands: grayscale (channels=0) -> (T, H, W) u8, u16 ->
    (T, H, W) u16 hi/lo-folded, color -> (T, H, W, C) u8. ``.npy``
    outputs are written through a memory-mapped array; anything else
    becomes a directory of one image per frame.
    """
    from .models import color as color_mod
    from .utils import imageio

    if not channels:
        oshape, odtype, save = (total, h, w), np.uint8, \
            imageio.save_grayscale
    elif kind == color_mod.KIND_U16:
        oshape, odtype, save = (total, h, w), np.uint16, imageio.save_gray16
    else:
        oshape, odtype, save = (total, h, w, channels), np.uint8, \
            imageio.save_color
    npy = out.suffix == ".npy"
    if npy:
        sink = np.lib.format.open_memmap(
            out, mode="w+", dtype=odtype, shape=oshape)
    else:
        out.mkdir(parents=True, exist_ok=True)
        sink = None
    return npy, sink, save


def _discard_streamed_output(out: Path, npy: bool) -> None:
    """Best-effort removal of a failed streaming decode's partial output.

    The batch decode paths fail before producing any file; the streaming
    paths write as they go, so on a failed integrity check the partial
    (possibly corrupt) .npy / frame images must not be left looking like
    a good decode. Image-directory output removes EVERY ``frame_*.png``
    in the directory, not just this run's — the directory is created
    with ``exist_ok=True``, so frames surviving from a previous longer
    run would otherwise masquerade as a complete good decode.
    """
    try:
        if npy:
            out.unlink(missing_ok=True)
        else:
            for p in out.glob("frame_*.png"):
                p.unlink(missing_ok=True)
    except OSError:
        pass  # the original failure still propagates


def _cmd_decode_video_streaming(args, data: bytes, cfg, check: bool,
                                salvage: bool) -> int:
    """decode-video --streaming: constant-memory segmented decode.

    Each MHV2 segment's frames are written to the output (.npy via a
    memory-mapped array, or one image per frame) as soon as they decode,
    then dropped — peak memory is one segment, independent of video
    length; the device pipeline (segment k+1 staged while k decodes)
    is unchanged. MHTC (color / u16) streams too: the inner plane chunks
    are folded to frames on the fly, carrying at most one partial frame
    of planes across a segment boundary. The recorded source CRC is
    still verified, streamed: chunk CRCs chain to the whole-payload
    CRC-32.
    """
    import dataclasses

    from .models import color as color_mod
    from .models import frame_stream

    for flag, what in [("frame", "--frame"), ("frames", "--frames"),
                       ("region", "--region")]:
        if getattr(args, flag, None) is not None:
            raise SystemExit(
                f"--streaming decodes the whole stream incrementally; "
                f"{what} is random access — drop one")
    if data[:4] == _temporal_magic():
        return _cmd_decode_video_streaming_temporal(args, data, cfg, check,
                                                    salvage)
    if data[:4] == frame_stream.STREAM_MAGIC:
        return _cmd_decode_video_streaming_mhts(args, data, cfg, check,
                                                salvage)
    kind, cs, channels = color_mod.KIND_U8, color_mod.CS_IDENTITY, 0
    inner = data
    if data[:4] == color_mod.COLOR_MAGIC:
        inner, channels, layout, kind, cs = color_mod.unwrap(data)
        if layout != color_mod.LAYOUT_VIDEO:
            raise SystemExit("--streaming needs a video container")
    ppf = 1 if not channels else (2 if kind == color_mod.KIND_U16
                                  else channels)
    if inner[:4] != frame_stream.SEGMENTED_MAGIC:
        raise SystemExit(
            "--streaming decode needs a segmented MHV2 (inner) or MHTS "
            "container (a one-piece MHTV decodes whole — drop --streaming, "
            "or `resegment` the archive first)")
    segs, n_planes, h, w, bd, delta = frame_stream.read_segmented(inner)
    if n_planes % ppf:
        raise SystemExit(
            f"MHTC inner frame count ({n_planes}) is not a multiple of "
            f"the declared {ppf} planes per frame")
    total = n_planes // ppf
    cfg = dataclasses.replace(
        cfg, block_dim=bd, delta=delta,
        delta2d=bool(segs) and segs[0][0].predictor == "2d")
    if check and cfg.backend != "pallas":
        raise SystemExit(
            "--check requires --backend pallas (the on-device integrity "
            "check is emitted by the decode kernel)")
    t0 = time.perf_counter()
    out = Path(args.output)
    npy, sink, save = _streamed_sink(out, total, h, w, channels, kind)

    n_corrupt = 0

    def checked_chunks():
        nonlocal n_corrupt
        for si, fr, err in frame_stream.iter_frames_segmented_checked(
                segs, h, w, cfg):
            if err.any():
                idx = np.nonzero(err)[0]
                if not salvage:
                    raise SystemExit(
                        f"stream integrity check failed in segment {si}: "
                        f"{idx.size} corrupt block(s), first at "
                        f"{idx[:8].tolist()}")
                fr, n = frame_stream.salvage_blocks(fr, err, cfg.block_dim)
                n_corrupt += n
                print(f"salvaged {idx.size} corrupt block(s) in segment "
                      f"{si}, first at {idx[:8].tolist()} (zero-filled)",
                      file=sys.stderr)
            yield fr

    chunks = (checked_chunks() if check
              else frame_stream.iter_frames_segmented(segs, h, w, cfg))
    crc = 0
    base = 0  # whole frames written so far
    carry = np.zeros((0, h, w), np.uint8)  # partial-frame planes
    try:
        for chunk in chunks:
            # the recorded CRC covers the raw plane payload, pre-fold
            crc = zlib.crc32(np.ascontiguousarray(chunk).tobytes(), crc)
            if carry.size:
                chunk = np.concatenate([carry, chunk])
            usable = (chunk.shape[0] // ppf) * ppf
            carry = chunk[usable:]
            if not usable:
                continue
            frames = (chunk[:usable] if not channels
                      else color_mod.fold_video_planes(
                          chunk[:usable], channels, kind, cs))
            if npy:
                sink[base : base + frames.shape[0]] = frames
            else:
                for i, f in enumerate(frames):
                    save(f, out / f"frame_{base + i:05d}.png")
            base += frames.shape[0]
        if n_corrupt:
            print(f"salvaged output: CRC checks skipped ({n_corrupt} "
                  "zero-filled block(s))", file=sys.stderr)
        else:
            recorded = frame_stream.source_crc32(inner)
            if recorded and crc != recorded:
                raise SystemExit(
                    "decoded payload fails the recorded source CRC-32 — "
                    "the stream is corrupt")
    except BaseException:
        # no partially-written/corrupt output left behind — the batch
        # path fails before producing any file; match it
        _discard_streamed_output(out, npy)
        raise
    if npy:
        sink.flush()
        del sink
    what = ("" if not channels
            else " u16" if kind == color_mod.KIND_U16 else f" {channels}ch")
    dt = time.perf_counter() - t0
    print(f"{args.input}: decoded {base}{what} frames {h}x{w} (streamed, "
          f"{len(segs)} segments) in {dt:.2f} s -> {args.output}")
    return 0


def _cmd_decode_video_streaming_mhts(args, data: bytes, cfg, check: bool,
                                     salvage: bool) -> int:
    """decode-video --streaming on an MHTS (per-frame-tables) container.

    MHTS is the most naturally streamable container in the format — every
    record is a self-contained MHT1 blob — so the reader is one frame at
    a time (``frame_stream.iter_stream_frames``): peak memory is one
    decoded frame. Each frame's recorded source CRC verifies as it is
    produced; ``--check`` adds the on-device end-bit check per frame
    (Pallas backend), with ``--salvage`` zero-filling corrupt blocks.
    """
    from .models import color as color_mod
    from .models import frame_stream

    if check and cfg.backend != "pallas":
        raise SystemExit(
            "--check requires --backend pallas (the on-device integrity "
            "check is emitted by the decode kernel)")
    try:
        total = frame_stream.stream_frame_count(data)
        first = next(frame_stream._iter_stream_records(data), None)
    except ValueError as e:
        raise SystemExit(str(e))
    if first is None:
        raise SystemExit("empty MHTS stream")
    _s, h, w, bd, _delta, _crc0 = first
    t0 = time.perf_counter()
    out = Path(args.output)
    npy, sink, save = _streamed_sink(out, total, h, w, 0,
                                     color_mod.KIND_U8)
    n_corrupt = 0
    base = 0
    try:
        try:
            for i, frame, err, crc in frame_stream.iter_stream_frames(
                    data, cfg, check=check):
                salvaged = False
                if err is not None and err.any():
                    idx = np.nonzero(err)[0]
                    if not salvage:
                        raise SystemExit(
                            f"stream integrity check failed in frame {i}: "
                            f"{idx.size} corrupt block(s), first at "
                            f"{idx[:8].tolist()}")
                    fr, n = frame_stream.salvage_blocks(frame[None], err,
                                                        bd)
                    frame = fr[0]
                    n_corrupt += n
                    salvaged = True
                    print(f"salvaged {idx.size} corrupt block(s) in frame "
                          f"{i}, first at {idx[:8].tolist()} "
                          "(zero-filled)", file=sys.stderr)
                if not salvaged and crc and zlib.crc32(
                        np.ascontiguousarray(frame).tobytes()) != crc:
                    raise SystemExit(
                        f"decoded frame {i} fails its recorded CRC-32 — "
                        "the stream is corrupt")
                if npy:
                    sink[i] = frame
                else:
                    save(frame, out / f"frame_{i:05d}.png")
                base += 1
        except ValueError as e:
            raise SystemExit(str(e))
    except BaseException:
        _discard_streamed_output(out, npy)
        raise
    if npy:
        sink.flush()
        del sink
    if n_corrupt:
        print(f"salvaged output: {n_corrupt} zero-filled block(s); their "
              "frames' CRC checks skipped", file=sys.stderr)
    dt = time.perf_counter() - t0
    print(f"{args.input}: decoded {base} frames {h}x{w} (streamed MHTS, "
          f"per-frame tables) in {dt:.2f} s -> {args.output}")
    return 0


def _temporal_magic() -> bytes:
    from .models import temporal

    return temporal.TEMPORAL_MAGIC


def _cmd_decode_video_streaming_temporal(args, data: bytes, cfg, check: bool,
                                         salvage: bool) -> int:
    """decode-video --streaming on an MHVT container.

    Chunks are keyframe-group-aligned (``temporal.iter_temporal_video``),
    so each residual frame decodes exactly once; the outer temporal CRC is
    verified streamed (chunk CRCs chain, mismatch fails after the last
    chunk) and any recorded per-frame CRC table verifies each chunk as it
    is produced.
    """
    from .models import color as color_mod
    from .models import temporal

    if check:
        raise SystemExit(
            "--streaming on MHVT verifies the temporal CRC (streamed) and "
            "any per-frame CRC table as it goes; for the on-device end-bit "
            "check run `verify` (or decode without --streaming)")
    # (the --frame/--frames/--region random-access guard already ran in
    # _cmd_decode_video_streaming, the only caller)
    inner, keyint, _tcrc, _mvs, _fcrcs, _fl = temporal.unwrap(data)
    total = temporal._inner_frame_count(inner)
    if total is None:
        raise SystemExit("corrupt MHVT container (unrecognized inner stream)")
    # output geometry/dtype from the inner container kind
    channels, kind = 0, color_mod.KIND_U8
    probe = inner
    if inner[:4] == color_mod.COLOR_MAGIC:
        probe, channels, layout, kind, _cs = color_mod.unwrap(inner)
        if layout != color_mod.LAYOUT_VIDEO:
            raise SystemExit("--streaming needs a video container")
    import struct as struct_mod

    _t, h, w = struct_mod.unpack_from("<III", probe, 4)[:3]
    t0 = time.perf_counter()
    out = Path(args.output)
    npy, sink, save = _streamed_sink(out, total, h, w, channels, kind)
    base = 0
    try:
        try:
            for start, chunk in temporal.iter_temporal_video(data, cfg):
                if npy:
                    sink[start : start + chunk.shape[0]] = chunk
                else:
                    for i, f in enumerate(chunk):
                        save(f, out / f"frame_{start + i:05d}.png")
                base = start + chunk.shape[0]
        except ValueError as e:
            raise SystemExit(str(e))
    except BaseException:
        # a failed CRC chain (or any mid-stream error) must not leave a
        # partial output that looks like a good decode
        _discard_streamed_output(out, npy)
        raise
    if npy:
        sink.flush()
        del sink
    dt = time.perf_counter() - t0
    print(f"{args.input}: decoded {base} frames {h}x{w} (streamed, "
          f"temporal keyint {keyint}) in {dt:.2f} s -> {args.output}")
    return 0


def cmd_decode_video(args) -> int:
    from .models import color, temporal
    from .utils import imageio

    data = Path(args.input).read_bytes()
    cfg = _config(args)
    check = getattr(args, "check", False)
    salvage = getattr(args, "salvage", False)
    if salvage and not check:
        raise SystemExit("--salvage needs --check (it zero-fills blocks "
                         "the on-device integrity check flags)")
    if getattr(args, "streaming", False):
        return _cmd_decode_video_streaming(args, data, cfg, check, salvage)
    if getattr(args, "region", None) is not None:
        return _cmd_decode_video_region(args, data, cfg)
    if data[:4] == temporal.TEMPORAL_MAGIC:
        return _cmd_decode_video_temporal(args, data, cfg, check, salvage)
    if data[:4] == color.COLOR_MAGIC:
        return _cmd_decode_video_color(args, data, cfg, check, salvage)
    if getattr(args, "frame", None) is not None:
        from .models import frame_stream

        # --frame verifies against any recorded per-frame CRCs (FCRC
        # extension / MHTS records) automatically; --check additionally
        # insists the container records them
        try:
            has_fcrcs = (
                any(frame_stream.read_stream_crcs(data))
                if data[:4] == frame_stream.STREAM_MAGIC
                else frame_stream.read_frame_crcs(data) is not None)
        except ValueError as e:  # not a video container / truncated FCRC
            raise SystemExit(str(e))
        if check and not has_fcrcs:
            raise SystemExit(
                "--frame --check needs per-frame CRCs; this container "
                "records none (encode with --frame-crcs), so only "
                "whole-stream verification is possible (`verify`)")
        t0 = time.perf_counter()
        img, h, w = _decode_one_frame(data, cfg, args.frame)
        dt = time.perf_counter() - t0
        out = Path(args.output)
        if out.suffix == ".npy":
            np.save(out, img)
        else:
            imageio.save_grayscale(np.asarray(img), out)
        checked = ", frame CRC ok" if has_fcrcs else ""
        print(f"{args.input}: decoded frame {args.frame} ({h}x{w}{checked}) "
              f"in {dt:.3f} s -> {args.output}")
        return 0
    if getattr(args, "frames", None) is not None:
        from .models import frame_stream

        if check:
            raise SystemExit(
                "--check verifies whole streams; --frames range access "
                "verifies any recorded per-frame CRCs automatically")
        a, b = args.frames
        t0 = time.perf_counter()
        try:
            frames, h, w = frame_stream.decode_range(data, a, b, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        dt = time.perf_counter() - t0
        out = Path(args.output)
        if out.suffix == ".npy":
            np.save(out, frames)
        else:
            out.mkdir(parents=True, exist_ok=True)
            for i, f in enumerate(frames):
                imageio.save_grayscale(f, out / f"frame_{a + i:05d}.png")
        print(f"{args.input}: decoded frames [{a}, {b}) ({h}x{w}) in "
              f"{dt:.3f} s -> {args.output}")
        return 0
    if check and args.backend != "pallas":
        # the whole-stream integrity check is an output of the Pallas
        # kernel (the decode carry); other backends never compute it —
        # refuse loudly rather than silently decode unchecked (--frame
        # --check above is CRC-based and backend-independent)
        raise SystemExit(
            "--check requires --backend pallas (the on-device integrity "
            "check is emitted by the decode kernel)")
    t0 = time.perf_counter()
    frames, t, h, w, bad = _decode_video_frames(data, cfg, check,
                                                salvage)
    # verify any recorded payload CRC — catches length-preserving corruption
    # the on-device end-bit check cannot see (same-width code substitutions);
    # salvaged output would trivially mismatch, so the check is skipped
    if bad:
        print(f"salvaged output: CRC checks skipped ({bad} zero-filled "
              "block(s))", file=sys.stderr)
    else:
        _verify_video_crc(data, frames)
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".npy":
        np.save(out, frames)
    else:
        out.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            imageio.save_grayscale(f, out / f"frame_{i:05d}.png")
    print(f"{args.input}: decoded {t} frames {h}x{w} in {dt:.2f} s -> {args.output}")
    return 0


def _cmd_decode_video_color(args, data: bytes, cfg, check: bool,
                            salvage: bool = False) -> int:
    """decode-video on an MHTC container: full decode, --frame, --check.

    The wrapper delegates to the grayscale machinery on the inner MHTV/MHV2
    plane stream (so the on-device integrity check and CRC verification run
    unchanged), then folds planes back to (T, H, W, C) / uint16.
    """
    from .models import color
    from .utils import imageio

    inner, channels, layout, kind, cs = color.unwrap(data)
    if layout != color.LAYOUT_VIDEO:
        raise SystemExit(
            f"{args.input} is an MHTC image container — use decode")
    if check and args.backend != "pallas":
        raise SystemExit(
            "--check requires --backend pallas (the on-device integrity "
            "check is emitted by the decode kernel)")
    if getattr(args, "frames", None) is not None:
        from .models import frame_stream

        if check:
            raise SystemExit(
                "--check verifies whole streams; --frames range access "
                "verifies any recorded per-frame CRCs automatically")
        a, b = args.frames
        t0 = time.perf_counter()
        try:
            planes, _h, _w = frame_stream.decode_range(
                inner, a * channels, b * channels, cfg)
            frames = color.fold_video_planes(planes, channels, kind, cs)
        except ValueError as e:
            raise SystemExit(str(e))
        dt = time.perf_counter() - t0
        out = Path(args.output)
        if out.suffix == ".npy":
            np.save(out, frames)
        else:
            out.mkdir(parents=True, exist_ok=True)
            save = (imageio.save_gray16 if kind == color.KIND_U16
                    else imageio.save_color)
            for i, f in enumerate(frames):
                save(f, out / f"frame_{a + i:05d}.png")
        print(f"{args.input}: decoded frames [{a}, {b}) in {dt:.3f} s "
              f"-> {args.output}")
        return 0
    if getattr(args, "frame", None) is not None:
        if check:
            raise SystemExit(
                "--check verifies whole streams; drop it for --frame "
                "random access (or run `verify` on the container)")
        t0 = time.perf_counter()
        try:
            img = color.decode_color_frame(data, args.frame, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
        dt = time.perf_counter() - t0
        out = Path(args.output)
        if out.suffix == ".npy":
            np.save(out, img)
        elif kind == color.KIND_U16:
            imageio.save_gray16(img, out)
        else:
            imageio.save_color(img, out)
        h, w = img.shape[:2]
        print(f"{args.input}: decoded frame {args.frame} ({h}x{w}) "
              f"in {dt:.3f} s -> {args.output}")
        return 0
    t0 = time.perf_counter()
    planes, n, h, w, bad = _decode_video_frames(inner, cfg, check,
                                                salvage)
    if bad:
        print(f"salvaged output: CRC checks skipped ({bad} zero-filled "
              "block(s))", file=sys.stderr)
    else:
        _verify_video_crc(inner, planes)
    frames = color.fold_video_planes(np.asarray(planes), channels, kind, cs)
    t = frames.shape[0]
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".npy":
        np.save(out, frames)
    else:
        out.mkdir(parents=True, exist_ok=True)
        save = (imageio.save_gray16 if kind == color.KIND_U16
                else imageio.save_color)
        for i, f in enumerate(frames):
            save(f, out / f"frame_{i:05d}.png")
    print(f"{args.input}: decoded {t} frames {h}x{w} in {dt:.2f} s "
          f"-> {args.output}")
    return 0


def _surgery_crc_note(out: bytes, op: str) -> None:
    """Warn when a surgery output records no whole-payload CRC.

    Surgery never decodes, so it can only COMBINE recorded CRCs; an input
    without one (or whose per-frame table is absent) silently yields an
    output `verify` cannot check — say so instead of staying quiet
    (round-3 advisor finding)."""
    from .models import color, frame_stream, temporal

    crc = 0
    data = out
    try:
        if data[:4] == temporal.TEMPORAL_MAGIC:
            crc = temporal.unwrap(data)[2]
        else:
            if data[:4] == color.COLOR_MAGIC:
                data = color.unwrap(data)[0]
            if data[:4] in (frame_stream.SHARED_MAGIC,
                            frame_stream.SEGMENTED_MAGIC):
                crc = frame_stream.source_crc32(data)
    except ValueError:
        return
    if not crc:
        print(f"note: the {op} output records no whole-payload CRC-32 (an "
              "input lacked one to combine from), so `mht verify` cannot "
              "check its payload; encode sources with --frame-crcs to keep "
              "slice-level integrity through surgery", file=sys.stderr)


def cmd_extract(args) -> int:
    """Cut frames [A, B) out of a video container WITHOUT re-encoding."""
    from .models import surgery

    data = Path(args.input).read_bytes()
    a, b = args.frames
    t0 = time.perf_counter()
    info: dict = {}
    try:
        out = surgery.extract_video(data, a, b, info)
    except ValueError as e:
        raise SystemExit(str(e))
    # surgery reports what it actually did — the CLI never re-derives
    # the keyframe-group math
    how = "no re-encode"
    if info.get("reencoded_frames"):
        how = (f"re-keyed first group ({info['reencoded_frames']} frame(s) "
               "re-encoded), rest spliced losslessly")
    Path(args.output).write_bytes(out)
    print(f"{args.input}: extracted frames [{a}, {b}) -> "
          f"{args.output} ({len(out)} bytes, {how}, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
    _surgery_crc_note(out, "extract")
    return 0


def cmd_concat(args) -> int:
    """Splice video containers end to end WITHOUT re-encoding."""
    from .models import surgery

    if getattr(args, "streaming", False):
        t0 = time.perf_counter()
        try:
            info = surgery.concat_videos_streamed(args.inputs, args.output)
        except (ValueError, OSError) as e:
            raise SystemExit(str(e))
        print(f"spliced {len(args.inputs)} file(s) -> {args.output} "
              f"({info['bytes']} bytes, {info['segments']} segments, "
              f"streamed copy, {(time.perf_counter() - t0) * 1e3:.1f} ms)")
        if not info["crc_recorded"]:
            # never re-read the (possibly huge) output just to notice this
            print("note: output records no whole-payload CRC (an input "
                  "lacked one) — `verify` cannot check it; re-encode with "
                  "--frame-crcs to keep slice-level integrity",
                  file=sys.stderr)
        return 0
    blobs = [Path(x).read_bytes() for x in args.inputs]
    t0 = time.perf_counter()
    try:
        out = surgery.concat_videos(blobs)
    except ValueError as e:
        raise SystemExit(str(e))
    Path(args.output).write_bytes(out)
    print(f"spliced {len(blobs)} container(s) -> {args.output} "
          f"({len(out)} bytes, no re-encode, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
    _surgery_crc_note(out, "concat")
    return 0


def cmd_resegment(args) -> int:
    """Re-cut a container's segment structure losslessly.

    Non-MHVT inputs ride the constant-memory file-to-file walker (mmap
    span copy, byte-identical output) so archives bigger than RAM — the
    feature's whole point — re-cut too; MHVT uses the in-memory form
    (its wrapper tables are header-resident and small).
    """
    from .models import surgery

    if args.segment_frames < 1:
        raise SystemExit("--segment-frames must be >= 1")
    t0 = time.perf_counter()
    with open(args.input, "rb") as f:
        head = f.read(4)
    try:
        if head == b"MHVT":
            out = surgery.resegment_video(
                Path(args.input).read_bytes(), args.segment_frames)
            Path(args.output).write_bytes(out)
            nbytes, crc_note = len(out), None
        else:
            info = surgery.resegment_video_streamed(
                args.input, args.output, args.segment_frames)
            nbytes, crc_note = info["bytes"], info["crc_recorded"]
    except (ValueError, OSError) as e:
        raise SystemExit(str(e))
    print(f"{args.input}: resegmented at <= {args.segment_frames} "
          f"frames/segment -> {args.output} ({nbytes} bytes, no "
          f"re-encode, {(time.perf_counter() - t0) * 1e3:.1f} ms)")
    if crc_note is None:
        _surgery_crc_note(out, "resegment")
    elif not crc_note:
        print("note: output records no whole-payload CRC (the input "
              "lacked one) — `verify` cannot check it", file=sys.stderr)
    return 0


def _cmd_verify_streaming_temporal(args, data: bytes, cfg) -> int:
    """verify --streaming on an MHVT wrapper: reconstruct in keyframe-
    group-aligned chunks, verifying the FCRC table per chunk and the
    outer temporal CRC streamed — peak memory is one chunk of true
    frames, independent of video length. The wrapper is parsed once for
    the report fields (plus ``iter_temporal_video``'s own working
    parse). A container recording NEITHER CRC is refused: a streamed
    verify that checks nothing must not print PASS — the batch verify
    covers those files via the inner stream's own checks."""
    import struct as struct_mod

    from .models import temporal

    try:
        _inner, keyint, tcrc, mvs, fcrcs, fl = temporal.unwrap(data)
        flags = struct_mod.unpack_from("<HHI", data, 4)[1]
        desc = temporal._describe_parts(keyint, tcrc, mvs, fcrcs, fl,
                                        flags)
    except ValueError as e:
        raise SystemExit(str(e))
    if not tcrc and fcrcs is None:
        raise SystemExit(
            "this MHVT records neither an outer CRC nor a per-frame CRC "
            "table, so the streamed verify has nothing to check — run "
            "the batch `verify` (it checks the inner residual stream's "
            "own CRC / end-bit integrity)")
    total = 0
    try:
        for base, chunk in temporal.iter_temporal_video(data, cfg):
            total = base + chunk.shape[0]
    except ValueError as e:
        raise SystemExit(str(e))
    print(desc)
    print(f"  {'decode':<15} ok ({total} frames, {args.backend}, "
          "streamed reconstruction)")
    print(f"  {'temporal CRC-32':<15} "
          + ("ok (chained, streamed)" if tcrc else "absent"))
    print(f"  {'frame CRC table':<15} "
          + (f"ok ({fcrcs.shape[0]} frames, per chunk)"
             if fcrcs is not None else "absent"))
    print("PASS")
    return 0


def _cmd_verify_streaming_mhts(args, data: bytes, cfg) -> int:
    """verify --streaming on an MHTS container: one frame at a time —
    per-frame recorded source CRCs, plus the on-device end-bit check per
    frame on the Pallas backend. Peak memory is one decoded frame."""
    from .models import frame_stream

    pallas = args.backend == "pallas"
    total = 0
    with_crc = 0
    h = w = None
    try:
        for i, frame, err, crc in frame_stream.iter_stream_frames(
                data, cfg, check=pallas):
            if err is not None and err.any():
                idx = np.nonzero(err)[0]
                raise SystemExit(
                    f"stream integrity check failed in frame {i}: "
                    f"{idx.size} corrupt block(s), first at "
                    f"{idx[:8].tolist()}")
            if crc:
                with_crc += 1
                if zlib.crc32(
                        np.ascontiguousarray(frame).tobytes()) != crc:
                    raise SystemExit(
                        f"decoded frame {i} fails its recorded CRC-32 — "
                        "the stream is corrupt")
            total += 1
            h, w = frame.shape
    except ValueError as e:
        raise SystemExit(str(e))
    if total == 0:
        # a zero-count header (corrupt or crafted) must not reach the
        # summary print with unbound geometry — and "verified nothing"
        # is not a PASS
        raise SystemExit("empty MHTS stream")
    print(f"MHTS: {total} frames {h}x{w} (streamed, per-frame tables)")
    print(f"  {'end-bit check':<14} "
          + ("ok (per frame)" if pallas
             else "skipped (needs --backend pallas)"))
    print(f"  {'decode':<14} ok ({total} frames, {args.backend}, streamed)")
    print(f"  {'source CRC-32':<14} "
          + (f"ok (per frame, {with_crc})" if with_crc else "absent"))
    print("PASS")
    return 0


def _cmd_verify_streaming(args, data: bytes, cfg) -> int:
    """verify --streaming: the full integrity chain at constant memory.

    For a segmented MHV2 (bare or inside MHTC) every check the batch
    verify runs — on-device end-bit per segment (Pallas backend), the
    recorded source CRC (chained chunk CRCs), the per-frame FCRC table
    (verified chunk by chunk) — without ever holding more than one
    decoded segment. The way to verify an archive bigger than RAM.
    An MHVT wrapper verifies through ``iter_temporal_video``: each
    keyframe-group-aligned chunk reconstructs (at most one chunk of
    true frames in memory), any FCRC table checks chunk by chunk, and
    the outer temporal CRC verifies streamed (chained chunk CRCs) —
    the outer CRC covers every inner bit, so nothing escapes.
    """
    import dataclasses

    from .models import color, frame_stream, temporal

    if data[:4] == temporal.TEMPORAL_MAGIC:
        return _cmd_verify_streaming_temporal(args, data, cfg)
    if data[:4] == frame_stream.STREAM_MAGIC:
        return _cmd_verify_streaming_mhts(args, data, cfg)
    wrapper = ""
    inner = data
    if data[:4] == color.COLOR_MAGIC:
        try:
            wrapper = color.describe(data) + " wrapping "
            inner, _ch, layout, _kind, _cs = color.unwrap(data)
        except ValueError as e:
            raise SystemExit(str(e))
        if layout != color.LAYOUT_VIDEO:
            raise SystemExit("verify --streaming needs a video container")
    if inner[:4] != frame_stream.SEGMENTED_MAGIC:
        raise SystemExit(
            "verify --streaming needs a segmented MHV2, MHTS, or MHVT "
            "container (a one-piece MHTV verifies whole; drop --streaming, "
            "or `resegment` the archive first)")
    pallas = args.backend == "pallas"
    try:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(inner)
    except ValueError as e:
        raise SystemExit(str(e))
    vcfg = dataclasses.replace(
        cfg, block_dim=bd, delta=delta,
        delta2d=bool(segs) and segs[0][0].predictor == "2d")
    fcrcs = frame_stream.read_frame_crcs(inner)
    recorded = frame_stream.source_crc32(inner)
    crc = 0
    base = 0
    if pallas:
        for si, fr, err in frame_stream.iter_frames_segmented_checked(
                segs, h, w, vcfg):
            if err.any():
                idx = np.nonzero(err)[0]
                raise SystemExit(
                    f"stream integrity check failed in segment {si}: "
                    f"{idx.size} corrupt block(s), first at "
                    f"{idx[:8].tolist()}")
            crc = zlib.crc32(np.ascontiguousarray(fr).tobytes(), crc)
            try:
                frame_stream.verify_frame_crcs(fr, fcrcs, base=base)
            except ValueError as e:
                raise SystemExit(str(e))
            base += fr.shape[0]
    else:
        for fr in frame_stream.iter_frames_segmented(segs, h, w, vcfg):
            crc = zlib.crc32(np.ascontiguousarray(fr).tobytes(), crc)
            try:
                frame_stream.verify_frame_crcs(fr, fcrcs, base=base)
            except ValueError as e:
                raise SystemExit(str(e))
            base += fr.shape[0]
    if recorded and crc != recorded:
        raise SystemExit(
            "decoded payload fails the recorded source CRC-32 — the "
            "stream is corrupt")
    print(f"{wrapper}MHV2: {t} frames {h}x{w} (streamed, "
          f"{len(segs)} segments)")
    print(f"  {'end-bit check':<14} "
          + ("ok" if pallas else "skipped (needs --backend pallas)"))
    print(f"  {'decode':<14} ok ({base} frames, {args.backend}, streamed)")
    print(f"  {'source CRC-32':<14} " + ("ok" if recorded else "absent"))
    print(f"  {'frame CRC table':<13} "
          + (f"ok ({fcrcs.shape[0]} frames)" if fcrcs is not None
             else "absent"))
    print("PASS")
    return 0


def cmd_verify(args) -> int:
    """Decode a container with every applicable integrity check and report.

    The CLI analog of the reference's capture/verify mode — readback plus
    byte-for-byte compare with assert-on-diff (``AAPLRenderer.m:1849-1876``)
    — for streams whose source is no longer at hand: parse, full decode,
    on-device per-block end-bit check (Pallas backend), and recorded
    source-CRC-32 verification. Exit 0 only when every check passes.
    """
    import dataclasses

    from .core import container
    from .models import color, frame_stream

    data = Path(args.input).read_bytes()
    cfg = _config(args)
    if getattr(args, "streaming", False):
        return _cmd_verify_streaming(args, data, cfg)
    pallas = args.backend == "pallas"
    lines = []

    def report(name: str, status: str) -> None:
        lines.append(f"  {name:<14} {status}")

    wrapper = ""
    temporal_ctx = None  # (keyint, outer crc) of an MHVT wrapper
    mhtc_ctx = None  # (channels, kind, colorspace) of an MHTC wrapper
    if data[:4] == b"MHVT":
        from .models import temporal

        try:
            wrapper = temporal.describe(data) + " wrapping "
            inner, keyint, tcrc, mvs, fcrcs, first_len = temporal.unwrap(
                data)
        except ValueError as e:
            raise SystemExit(str(e))
        temporal_ctx = (keyint, tcrc, mvs, fcrcs, first_len)
        data = inner
    if data[:4] == color.COLOR_MAGIC:
        # verify the inner plane stream; every check (end-bit, CRC) applies
        # to the planes exactly as to grayscale frames
        try:
            wrapper += color.describe(data) + " wrapping "
            inner, channels, layout, kind, cs = color.unwrap(data)
        except ValueError as e:
            raise SystemExit(str(e))
        mhtc_ctx = (channels, kind, cs)
        data = inner

    try:
        if data[:4] == container.DISK_MAGIC:
            stream, h, w, bd, delta, crc = container.read_frame(data)
            mode = ("delta2d" if stream.predictor == "2d"
                    else "delta" if delta else "none")
            if stream.block_init is not None:
                mode = ("zero-init" if mode == "delta"
                        else mode + "+zero-init")
            head = (f"MHT1: {h}x{w}, block_dim={bd}, mode={mode}, "
                    f"{stream.block_offsets.size} blocks")
            if pallas:
                dcfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                           delta2d=stream.predictor == "2d")
                prep = frame_stream.prepare_shared(
                    stream, 1, h, w, dcfg, check=True)
                img, err = frame_stream.decode_shared_step_checked(prep, dcfg)
                if err.any():
                    idx = np.nonzero(err)[0]
                    raise SystemExit(
                        f"stream integrity check failed: {idx.size} corrupt "
                        f"block(s), first at {idx[:8].tolist()}")
                report("end-bit check", f"ok ({int(err.size)} blocks)")
                out = np.asarray(img).reshape(h, w)
                if crc and zlib.crc32(out.tobytes()) != crc:
                    raise SystemExit(
                        "decoded image fails the container's source CRC-32 "
                        "(corrupt stream or decoder mismatch)")
            else:
                from .models import ImageCodec

                out = ImageCodec(cfg).decode(data)  # verifies any CRC itself
                report("end-bit check", "skipped (needs --backend pallas)")
            report("decode", f"ok ({h}x{w}, {args.backend})")
            report("source CRC-32", "ok" if crc else "absent")
        elif data[:4] in (frame_stream.SHARED_MAGIC,
                          frame_stream.SEGMENTED_MAGIC,
                          frame_stream.STREAM_MAGIC):
            kind = {frame_stream.SHARED_MAGIC: "MHTV",
                    frame_stream.SEGMENTED_MAGIC: "MHV2",
                    frame_stream.STREAM_MAGIC: "MHTS"}[bytes(data[:4])]
            frames, t, h, w, _bad = _decode_video_frames(
                data, cfg, check=pallas)
            head = f"{kind}: {t} frames {h}x{w}"
            report("end-bit check",
                   "ok" if pallas else "skipped (needs --backend pallas)")
            report("decode", f"ok ({t} frames, {args.backend})")
            recorded = _verify_video_crc(data, frames)
            report("source CRC-32", "ok" if recorded else "absent")
            if data[:4] in (frame_stream.SHARED_MAGIC,
                            frame_stream.SEGMENTED_MAGIC):
                fcrcs = frame_stream.read_frame_crcs(data)
                frame_stream.verify_frame_crcs(np.asarray(frames), fcrcs)
                report("frame CRC table",
                       f"ok ({fcrcs.shape[0]} frames)" if fcrcs is not None
                       else "absent")
            if temporal_ctx is not None:
                # reconstruct the true frames and pin them against the
                # MHVT outer CRC (catches wrapper-header corruption the
                # inner checks cannot see)
                from .models import temporal

                keyint, tcrc, mvs, fcrcs, first_len = temporal_ctx
                res = np.asarray(frames)
                if mhtc_ctx is not None:
                    res = color.fold_video_planes(res, *mhtc_ctx)
                true = (temporal.temporal_decode_mc(res, keyint, mvs,
                                                    first_len=first_len)
                        if mvs is not None
                        else temporal.temporal_decode(
                            res, keyint, first_len=first_len))
                if tcrc and zlib.crc32(
                        np.ascontiguousarray(true).tobytes()) != tcrc:
                    raise SystemExit(
                        "reconstructed frames fail the MHVT source CRC-32 "
                        "— corrupt container")
                report("temporal CRC-32", "ok" if tcrc else "absent")
                temporal._verify_frame_crcs(true, fcrcs)  # ValueError -> exit
                report("temporal frame CRCs",
                       f"ok ({fcrcs.shape[0]} frames)" if fcrcs is not None
                       else "absent")
        else:
            raise SystemExit("not an MHT1/MHTS/MHTV/MHV2 container")
    except ValueError as e:
        raise SystemExit(str(e))
    print(wrapper + head)
    for ln in lines:
        print(ln)
    print("PASS")
    return 0


def cmd_inspect(args) -> int:
    """Debug view of an MHT1/MHTV stream (table dump / per-block symbol trace)."""
    from .core import container
    from .models import color, frame_stream, temporal
    from .utils import debug

    data = Path(args.input).read_bytes()
    if data[:4] == temporal.TEMPORAL_MAGIC:
        print(temporal.describe(data))
        data = temporal.unwrap(data)[0]  # inspect the residual stream
    if data[:4] == color.COLOR_MAGIC:
        print(color.describe(data))
        data = color.unwrap(data)[0]  # inspect the inner plane stream
    if data[:4] == frame_stream.SHARED_MAGIC:
        stream, _t, h, w, bd, delta = frame_stream.read_shared(data)
    else:
        stream, h, w, bd, delta, _crc = container.read_frame(data)
    print(debug.stream_summary(stream))
    if args.table:
        print(debug.dump_table(stream.widths))
    if args.block is not None:
        print(f"\nblock {args.block} trace (bit_offset width pattern sym value):")
        for t in debug.trace_block(stream, args.block, bd * bd, delta):
            print(f"  [{t.index:3d}] {t.bit_offset:10d} {t.width:2d} "
                  f"{t.pattern:>16s} {t.symbol:3d} {t.value:3d}")
    return 0


def cmd_platform(args) -> int:
    """Print the JAX platform and device the device paths would use."""
    import jax

    from .ops import decode_pallas

    dev = jax.devices()[0]
    mode = "interpreted" if decode_pallas.interpret_mode() else "compiled"
    print(f"{dev.platform} {dev.device_kind} x{len(jax.devices())} "
          f"(decode kernel {mode})")
    return 0


def cmd_bench(args) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench

    from .utils import runtime

    runtime.require_gpu()
    gbps = bench.run_video(args.height, args.width, args.frames, args.iters, True)
    print(f"{gbps:.3f} GB/s")
    return 0


def main(argv=None) -> int:
    from . import __version__
    from .utils import runtime

    runtime.configure_compile_cache()

    ap = argparse.ArgumentParser(prog="metalhuffman", description=__doc__)
    ap.add_argument("--version", action="version",
                    version=f"metalhuffman {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode",
                       help="image file -> MHT1 (or MHTC color) container")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--color", action="store_true",
                   help="keep color: planar RGB(A) channels in an MHTC "
                        "container (default converts to grayscale like the "
                        "reference's CoreGraphics path)")
    p.add_argument("--gray16", action="store_true",
                   help="16-bit grayscale (uint16 .npy or 16-bit PNG) as "
                        "hi/lo byte planes in an MHTC container")
    p.add_argument("--subgreen", action="store_true",
                   help="with --color: store sub-green planes (R-G, G, B-G "
                        "mod 256) — smaller on natural photos")
    p.add_argument("--best", action="store_true",
                   help="measure precoders (and with --color, colorspaces) "
                        "on the payload and keep the smallest container")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode",
                       help="MHT1/MHTC container -> image file (auto-detects "
                            "color / 16-bit wrappers)")
    p.add_argument("input")
    p.add_argument("output")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="encode+decode+verify bit-exact")
    p.add_argument("input")
    p.add_argument("--color", action="store_true",
                   help="roundtrip in color (MHTC planar channels)")
    p.add_argument("--gray16", action="store_true",
                   help="roundtrip 16-bit grayscale (MHTC hi/lo planes; "
                        "input: uint16 .npy or 16-bit PNG)")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser("encode-video", help="frame stack/dir -> MHTV container")
    p.add_argument("input", help=".npy (T,H,W) uint8 stack or image directory")
    p.add_argument("output")
    p.add_argument("--per-frame-tables", action="store_true",
                   help="MHTS with a canonical table per frame (default: one "
                        "shared table, single fused batch decode)")
    p.add_argument("--best", action="store_true",
                   help="measure none/delta/delta2d on the payload and keep "
                        "the smallest (encode runs once per candidate)")
    p.add_argument("--color", action="store_true",
                   help="color video: (T,H,W,C) uint8 .npy or a directory "
                        "of color images -> MHTC container")
    p.add_argument("--gray16", action="store_true",
                   help="16-bit video: (T,H,W) uint16 .npy stack -> MHTC "
                        "container (hi/lo byte planes)")
    p.add_argument("--subgreen", action="store_true",
                   help="with --color: store sub-green planes (R-G, G, B-G "
                        "mod 256) — smaller on natural photos")
    p.add_argument("--temporal", action="store_true",
                   help="inter-frame prediction (MHVT wrapper): frames "
                        "become mod-256 residuals vs the previous frame "
                        "with a literal keyframe every --keyint — much "
                        "smaller on temporally redundant video")
    p.add_argument("--keyint", type=int, default=8, metavar="K",
                   help="with --temporal: keyframe interval (bounds "
                        "--frame random-access work; default 8)")
    p.add_argument("--motion", action="store_true",
                   help="with --temporal: global motion compensation — "
                        "each frame's predictor is the previous frame "
                        "circularly shifted by an estimated (dy, dx); "
                        "cancels panning, still lossless")
    p.add_argument("--best-fast", action="store_true",
                   help="with --temporal: like --best but candidate sizes "
                        "are estimated on a strided frame subsample and "
                        "only the two best-ranked are fully encoded "
                        "(>= 5x less encode work on long videos)")
    p.add_argument("--frame-crcs", action="store_true",
                   help="record a per-frame CRC-32 table (4 B/frame) so "
                        "--frame / range random access verifies exactly "
                        "the frames it touches (whole-payload CRCs cannot "
                        "cover a slice)")
    p.add_argument("--streaming", action="store_true",
                   help="memory-bounded encode: consume the input "
                        "incrementally (.npy via mmap, directories one "
                        "image at a time) and write MHV2 segments as they "
                        "fill — peak memory is one segment of raw frames, "
                        "independent of video length; composes with "
                        "--color/--gray16/--subgreen (MHTC), --temporal "
                        "[--motion] (MHVT trailer layout), and "
                        "--per-frame-tables (MHTS) — but not --best")
    p.add_argument("--append", action="store_true",
                   help="with --streaming: RESUME an existing finalized "
                        "container in place (capture resume) — new frames "
                        "chain onto the recorded CRC/FCRC tables and, "
                        "for --temporal, the keyframe cadence and "
                        "motion table continue; "
                        "byte-identical to concatenating the parts, and "
                        "a failed append restores the original file "
                        "untouched")
    p.add_argument("--segment-frames", type=int, default=None, metavar="N",
                   help="with --streaming: cap frames per MHV2 segment to "
                        "bound peak memory below the u32 offset-cap "
                        "capacity (default)")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_encode_video)

    p = sub.add_parser("decode-video",
                       help="MHTV/MHV2/MHTS/MHTC/MHVT -> .npy or image dir")
    p.add_argument("input")
    p.add_argument("output", help=".npy path or output directory for PNGs")
    p.add_argument("--check", action="store_true",
                   help="on-device stream-integrity check (MHTV/MHV2/MHTS; "
                        "requires --backend pallas): fail if any block does "
                        "not end at its indexed bit position")
    p.add_argument("--frame", type=int, default=None, metavar="N",
                   help="decode ONLY frame N (temporal random access via "
                        "the block offset index; output is one image/.npy)")
    p.add_argument("--salvage", action="store_true",
                   help="with --check: zero-fill corrupt blocks and keep "
                        "decoding instead of failing (best-effort serving; "
                        "CRC checks are skipped and the count reported)")
    p.add_argument("--streaming", action="store_true",
                   help="constant-memory decode of a segmented MHV2 "
                        "(bare, or inside MHTC color/u16): each segment's "
                        "frames are written out (.npy via mmap, or "
                        "images) as soon as they decode, then dropped — "
                        "peak memory is one segment; the source CRC is "
                        "verified streamed (chunk CRCs chain)")
    p.add_argument("--frames", type=int, nargs=2, default=None,
                   metavar=("A", "B"),
                   help="decode ONLY frames [A, B) (range random access "
                        "via the block offset index; verifies per-frame "
                        "CRCs when the container records them)")
    p.add_argument("--region", type=int, nargs=4, default=None,
                   metavar=("Y", "X", "H", "W"),
                   help="decode ONLY the (H, W) crop at (Y, X) — combined "
                        "with --frame/--frames this touches just those "
                        "frames' region blocks (spatio-temporal random "
                        "access); MHTV/MHV2/MHTC/MHVT containers. With "
                        "--check the end-bit integrity check verifies "
                        "exactly the touched blocks")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_decode_video)

    p = sub.add_parser(
        "extract",
        help="cut frames [A, B) out of a video container WITHOUT "
             "re-encoding (bit-identical code spans; CRCs combine "
             "algebraically from any per-frame table). An MHVT start "
             "inside a keyframe group re-encodes ONLY that group and "
             "splices the rest losslessly")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frames", type=int, nargs=2, required=True,
                   metavar=("A", "B"))
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser(
        "concat",
        help="splice video containers end to end WITHOUT re-encoding "
             "(each input's streams become MHV2 segments with their own "
             "canonical tables)")
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--streaming", action="store_true",
                   help="constant-memory file-to-file splice (mmap span "
                        "copy; byte-identical output) for archives bigger "
                        "than RAM — MHTV/MHV2/MHTC inputs")
    p.set_defaults(fn=cmd_concat)

    p = sub.add_parser(
        "resegment",
        help="re-cut a video container's MHV2 segment structure WITHOUT "
             "re-encoding (bit-identical trimmed spans; CRC/FCRC carry "
             "over verbatim) — gives a monolithic archive the segment "
             "granularity that bounds decode-video --streaming memory")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--segment-frames", type=int, required=True, metavar="N",
                   help="max frames per output segment (input segments "
                        "only ever split — each carries its own canonical "
                        "table, so merging would need a re-encode)")
    p.set_defaults(fn=cmd_resegment)

    p = sub.add_parser("info", help="describe an MHT1/MHTS container")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "verify",
        help="decode any container with every integrity check "
             "(end-bit + recorded CRC-32) and report per-check status")
    p.add_argument("input")
    p.add_argument("--streaming", action="store_true",
                   help="constant-memory verify of a segmented MHV2 (bare "
                        "or MHTC): per-segment end-bit check, chained "
                        "source CRC, per-chunk frame-CRC table — verify "
                        "an archive bigger than RAM")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("inspect", help="debug dump of an MHT1 stream")
    p.add_argument("input")
    p.add_argument("--table", action="store_true", help="dump canonical table")
    p.add_argument("--block", type=int, default=None,
                   help="trace this block symbol-by-symbol")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "platform", help="print the JAX platform the device paths use")
    p.add_argument("--interpret", action="store_true",
                   help="force the CPU platform (as the codec commands do)")
    p.set_defaults(fn=cmd_platform)

    p = sub.add_parser("bench", help="single-GPU decode benchmark")
    p.add_argument("--height", type=int, default=1536)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if getattr(args, "interpret", False):
        runtime.force_cpu_platform()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
