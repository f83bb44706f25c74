"""Headline benchmark: single-GPU Huffman decode throughput.

Decodes a 30-frame 2048x1536 8-bit grayscale video batch (the reference's
motivating workload: full-screen iPad video, ``README.md:9-11``; each frame is
the BigBridge.png geometry — 49,152 8x8 blocks,
``Shared/HuffRenderFrame.m:593-613``) with the decode kernel in a single
dispatch (shared canonical table across frames) and reports decoded GB/s.
``--content photo`` uses the committed real-photo asset (panned per frame)
instead of synthetic content. Runs only on a GPU: on any other platform it
exits non-zero before measuring.

Baseline: the reference's stated target is 2048x1536 @ 30 FPS on an iPad GPU
== 0.094 GB/s decoded bytes (``README.md:11``, BASELINE.md). ``vs_baseline``
is the multiple of that target.

The timed loop round-robins several independently staged input batches
(frame-order rotations: identical symbol multiset, different bitstreams in
different device buffers) and ends each repetition with
``jax.block_until_ready``. The same-input rate and a per-dispatch latency
histogram go to stderr as diagnostics.

Prints exactly ONE JSON line on stdout:
    {"metric": "decode_throughput", "value": N, "unit": "GB/s",
     "vs_baseline": N, "reps": R, "spread_pct": S}
``value`` is the MEDIAN of R timed repetitions and ``spread_pct`` is
(max-min)/median across them — the per-rep list goes to stderr. Movement
between runs smaller than the spread is noise, not a regression.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_GBPS = 0.094  # 2048*1536 bytes * 30 FPS (reference target)


def synthetic_frame(h: int, w: int, seed: int = 0, phase: int = 0) -> np.ndarray:
    """Smooth gradients + mild noise: delta+Huffman compresses this like a
    natural photo (~55%), matching the reference's real-image workload."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 96 + 80 * np.sin((xx + 3 * phase) / 97.0) * np.cos(yy / 71.0) + xx * 0.01
    img = base + rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _barrier(x):
    """Completion barrier: wait for the device to finish ``x``."""
    import jax

    jax.block_until_ready(x)


def _raw_words(words, offsets, t1, t2, *, num_frames, height, width):
    """The production decode as a traceable call: raw image words of a
    staged delta-coded 8x8 batch (``frame_stream.decode_shared_step``'s
    ``raw=True`` path)."""
    from metalhuffman.models import frame_stream

    return frame_stream._decode_shared_jit(
        words, offsets, t1, t2, backend="pallas", num_frames=num_frames,
        height=height, width=width, block_dim=8, delta=True, delta2d=False,
        raw=True, emit_end=False, wpr=0, k1=8, k2=8)


def photo_frames(height: int, width: int, frames: int) -> np.ndarray:
    """(T, H, W) real photographic frames: the committed bridge asset, tiled
    to the requested geometry and panned 8 px/frame (content statistics stay
    photographic; every frame's bitstream differs)."""
    from metalhuffman.utils import fixtures

    img = fixtures.render_frame("bridge")
    reps = (-(-height // img.shape[0]), -(-width // img.shape[1]))
    img = np.tile(img, reps)[:height, :width]
    return np.stack(
        [np.roll(img, (8 * t, 8 * t), axis=(0, 1)) for t in range(frames)]
    )


def run_video(height: int, width: int, frames: int, iters: int, verbose: bool,
              content: str = "synthetic", variants: int = 4,
              precoder: str = "delta"):
    import jax

    from metalhuffman.models import CodecConfig, frame_stream

    cfg = CodecConfig(backend="pallas", delta2d=precoder == "delta2d")
    if content == "photo":
        base = photo_frames(height, width, frames)
    else:
        base = np.stack(
            [synthetic_frame(height, width, seed=0, phase=i)
             for i in range(frames)]
        )
    # Distinct input batches for the timed loop: frame-order rotations give
    # an identical symbol multiset (same canonical table => same kernel
    # constants, ONE compiled executable) but different bitstreams staged in
    # different device buffers — so no two consecutive dispatches are
    # upstream-elidable as identical.
    variants = max(1, min(variants, frames))
    batches = [np.roll(base, v, axis=0) for v in range(variants)]
    t0 = time.perf_counter()
    streams = [frame_stream.encode_frames_shared(b, cfg) for b in batches]
    t_enc = time.perf_counter() - t0

    preps = [frame_stream.prepare_shared(s, frames, height, width, cfg)
             for s in streams]
    # production path: the kernel emits image words (delta2d reconstructs
    # in kernel registers); bytes are a free host view
    decodes = [
        (lambda p=p: frame_stream.decode_shared_step(p, cfg, raw=True))
        for p in preps]
    to_img = lambda r: frame_stream.frames_from_raw(r, frames, height, width)
    for v, (d, b) in enumerate(zip(decodes, batches)):
        out = to_img(d())
        if not np.array_equal(out, b):
            print(
                f"FATAL: decode mismatch on variant {v} "
                f"({int((out != b).sum())} bytes)",
                file=sys.stderr,
            )
            sys.exit(1)

    for d in decodes:  # warmup + ensure staging complete
        _barrier(d())

    def timed_loop(seq, reps: int = 5) -> list[float]:
        """Wall time of EACH of ``reps`` runs over the dispatch sequence.

        All reps are returned (not best-of): the reported number is the
        MEDIAN and the JSON carries the spread.
        """
        times = []
        for _rep in range(reps):
            t0 = time.perf_counter()
            r = None
            for d in seq:
                r = d()
            _barrier(r)
            times.append(time.perf_counter() - t0)
        return times

    # headline: round-robin the distinct batches
    times = timed_loop([decodes[i % variants] for i in range(iters)])
    rates = sorted(base.size * iters / t / 1e9 for t in times)
    gbps = rates[len(rates) // 2]  # median
    spread_pct = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    dt = sorted(times)[len(times) // 2]
    print(f"per-rep GB/s (n={len(rates)}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread_pct:.1f}%", file=sys.stderr)
    # diagnostic: the same-input loop (if this runs far faster than the
    # varied loop, caching of identical inputs is interfering)
    dt_same = min(timed_loop([decodes[0]] * iters, reps=3))
    gbps_same = base.size * iters / dt_same / 1e9

    if verbose:
        # per-dispatch latency distribution (each sample barriered)
        lat = []
        for i in range(3 * variants):
            t0 = time.perf_counter()
            _barrier(decodes[i % variants]())
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        ratio = streams[0].compressed_size / base.size
        per_frame = dt / iters / frames * 1e3
        agree = gbps / gbps_same if gbps_same else float("nan")
        print(
            f"device={jax.devices()[0].device_kind} frames={frames} "
            f"frame={height}x{width} iters={iters} content={content} "
            f"variants={variants} precoder={precoder}\n"
            f"encode(host)={t_enc:.2f} s for {variants}x{base.size/1e6:.0f} MB  "
            f"compressed={streams[0].compressed_size} B ({ratio:.1%})\n"
            f"decode={per_frame:.3f} ms/frame  varied={gbps:.2f} GB/s  "
            f"same-input={gbps_same:.2f} GB/s (ratio {agree:.2f})  "
            f"({gbps*1e9/(height*width):.0f} FPS-equivalent)\n"
            f"per-dispatch ms (barriered, n={len(lat)}): "
            f"min={lat[0]:.2f} p50={lat[len(lat)//2]:.2f} max={lat[-1]:.2f}",
            file=sys.stderr,
        )
    return gbps, len(rates), spread_pct


def run_temporal(height: int, width: int, frames: int, iters: int,
                 verbose: bool, content: str = "synthetic",
                 variants: int = 4, keyint: int = 8):
    """Temporal (MHVT) decode throughput: kernel decode + ON-DEVICE fold.

    The production MHVT path (``models.temporal._decode_temporal_device``):
    the decode kernel emits raw packed image words, a fori-loop of
    single-slot SWAR adds reconstructs the keyint groups in place, and the host
    views bytes for free — one fused jit program per dispatch. The stderr
    diagnostic reports the plain (fold-less) rate from the same staged
    inputs so the fold's cost is measured, not guessed.
    """
    from functools import partial

    import jax

    from metalhuffman.models import CodecConfig, frame_stream, temporal
    from metalhuffman.ops.decode_pallas import padded_geometry

    cfg = CodecConfig(backend="pallas")
    if content == "photo":
        base = photo_frames(height, width, frames)
    else:
        base = np.stack(
            [synthetic_frame(height, width, seed=0, phase=i)
             for i in range(frames)])
    res = temporal.temporal_encode(base, keyint)
    variants = max(1, min(variants, frames))
    batches = [np.roll(res, v, axis=0) for v in range(variants)]
    t0 = time.perf_counter()
    streams = [frame_stream.encode_frames_shared(b, cfg) for b in batches]
    t_enc = time.perf_counter() - t0
    preps = [frame_stream.prepare_shared(s, frames, height, width, cfg)
             for s in streams]
    rows_pf, w_pad = padded_geometry(height, width)

    @partial(jax.jit, static_argnames=("fold",))
    def step(words, offsets, t1, t2, *, fold):
        x = _raw_words(words, offsets, t1, t2, num_frames=frames,
                       height=height, width=width)
        if not fold:
            return x
        return temporal.temporal_fold_words_jax(x, keyint)

    def make(p, fold):
        return lambda: step(p.words, p.offsets, p.t1, p.t2, fold=fold)

    decodes = [make(p, True) for p in preps]
    plains = [make(p, False) for p in preps]
    for v, (d, b) in enumerate(zip(decodes, batches)):
        out = np.asarray(d()).view(np.uint8).reshape(frames, rows_pf, w_pad)
        want = temporal.temporal_decode(b, keyint)
        if not np.array_equal(out[:, :height, :width], want):
            print(f"FATAL: temporal decode mismatch on variant {v}",
                  file=sys.stderr)
            sys.exit(1)
        if v == 0 and not np.array_equal(out[:, :height, :width], base):
            print("FATAL: variant 0 does not reconstruct the source",
                  file=sys.stderr)
            sys.exit(1)
    for d in plains + decodes:
        _barrier(d())

    def timed(seq, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = None
            for d in seq:
                r = d()
            _barrier(r)
            times.append(time.perf_counter() - t0)
        return times

    rates = sorted(base.size * iters / t / 1e9
                   for t in timed([decodes[i % variants] for i in range(iters)]))
    gbps = rates[len(rates) // 2]
    spread = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    plain_rates = sorted(
        base.size * iters / t / 1e9
        for t in timed([plains[i % variants] for i in range(iters)], reps=3))
    plain_gbps = plain_rates[len(plain_rates) // 2]
    print(f"per-rep GB/s (n={len(rates)}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread:.1f}%", file=sys.stderr)
    if verbose:
        ratio = streams[0].compressed_size / base.size
        print(
            f"device={jax.devices()[0].device_kind} frames={frames} "
            f"frame={height}x{width} keyint={keyint} content={content}\n"
            f"encode(host)={t_enc:.2f} s  "
            f"compressed={streams[0].compressed_size} B ({ratio:.1%})\n"
            f"MHVT decode+fold={gbps:.2f} GB/s  plain decode={plain_gbps:.2f} "
            f"GB/s  fold cost={plain_gbps/gbps:.2f}x",
            file=sys.stderr,
        )
    return gbps, len(rates), spread


def run_temporal_ext(height: int, width: int, frames: int, iters: int,
                     verbose: bool, content: str = "synthetic",
                     variants: int = 4, keyint: int = 8,
                     motion: bool = False, inner: str = "gray"):
    """Temporal decode+fold throughput: the MC / color / u16 fold chains.

    ``run_temporal`` covers the plain-grayscale production path (raw packed
    words + SWAR group fold). This covers the OTHER chains
    ``models.temporal._decode_temporal_device`` takes, with the same
    methodology (distinct staged inputs, dependent-reduction barrier,
    median of reps):

    Since round 5 every chain runs the words-domain production path:

    - ``motion=True`` (gray): raw packed strips + the packed-words MC fold
      (``temporal_fold_words_mc_jax`` — row/word rolls + byte rotate +
      SWAR add; padded geometries via the double-roll + byte-mask select);
    - ``inner="color"``: plane-words group fold
      (``temporal_fold_plane_words_jax``) + the word-domain channel
      interleave (``_interleave_words_jax`` — the host view of the output
      words IS the (T, H, W, C) frames);
    - ``inner="u16"``: hi/lo carry fold (``temporal_fold_u16_words_jax``)
      + word-domain LE interleave (host view = u16 frames);
    - ``motion=True`` + ``inner="color"``: per-plane MC rolls in the same
      words fold, then the interleave.

    The stderr diagnostic reports the plain (fold-less) strips-decode
    rate from the same staged inputs, so the printed cost factor isolates
    the reconstruction chain. Decoded bytes are TRUE-frame bytes
    (``base.nbytes``) — for color/u16 the plane payload is the same size.
    """
    from functools import partial

    import jax
    import jax.numpy as jnp

    from metalhuffman.models import (CodecConfig, color, frame_stream,
                                         temporal)
    from metalhuffman.ops.decode_pallas import padded_geometry

    cfg = CodecConfig(backend="pallas")
    if content == "photo":
        gray = photo_frames(height, width, frames)
    else:
        gray = np.stack([synthetic_frame(height, width, seed=0, phase=i)
                         for i in range(frames)])
    if inner == "color":
        # correlated channels (column-shifted copies): compresses like a
        # natural RGB photo under the identity colorspace
        base = np.stack([np.roll(gray, 3 * c, axis=2) for c in range(3)],
                        axis=-1)
        channels, kind = 3, color.KIND_U8
    elif inner == "u16":
        # depth-map-like: smooth content scaled past 8 bits (hi plane keeps
        # the gradient statistics, lo plane the fine detail)
        base = ((gray.astype(np.uint16) << 4) | (gray >> 4)).astype(np.uint16)
        channels, kind = 2, color.KIND_U16
    else:
        base = gray
        channels, kind = 1, color.KIND_U8

    variants = max(1, min(variants, frames))
    sets = []
    t0 = time.perf_counter()
    for v in range(variants):
        fr = np.roll(base, v, axis=0)
        if motion:
            res, mvs = temporal.temporal_encode_mc(fr, keyint)
        else:
            res, mvs = temporal.temporal_encode(fr, keyint), None
        if inner == "color":
            planes = res.transpose(0, 3, 1, 2).reshape(-1, height, width)
        elif inner == "u16":
            planes = np.stack([(res >> 8).astype(np.uint8),
                               (res & 0xFF).astype(np.uint8)],
                              axis=1).reshape(-1, height, width)
        else:
            planes = res
        stream = frame_stream.encode_frames_shared(planes, cfg)
        prep = frame_stream.prepare_shared(
            stream, planes.shape[0], height, width, cfg)
        sets.append((fr, stream, prep,
                     None if mvs is None else jnp.asarray(mvs, jnp.int32)))
        print(f"variant {v} encoded+staged "
              f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)
    t_enc = time.perf_counter() - t0
    rows_pf, w_pad = padded_geometry(height, width)
    ppf = 2 if inner == "u16" else (3 if inner == "color" else 1)
    n_planes = frames * ppf

    @partial(jax.jit, static_argnames=("fold",))
    def step(words, offsets, t1, t2, mv, *, fold):
        # the production chain for EVERY kind: raw image words from the
        # kernel -> SWAR word fold (plane-major for color, carry pairs for
        # u16, double-roll padded MC) -> one device relayout for color/u16
        # (gray words are a free host byte view)
        x = _raw_words(words, offsets, t1, t2, num_frames=n_planes,
                       height=height, width=width)
        if not fold:
            return x
        if motion:
            folded = temporal.temporal_fold_words_mc_jax(
                x, keyint, mv, height=height, width=width,
                planes_per_frame=ppf, carry_u16=inner == "u16")
        elif inner == "u16":
            folded = temporal.temporal_fold_u16_words_jax(x, keyint)
        elif inner == "color":
            folded = temporal.temporal_fold_plane_words_jax(x, keyint, ppf)
        else:
            folded = temporal.temporal_fold_words_jax(x, keyint)
        if inner == "gray":
            return folded
        # production relayout: word-domain channel interleave (the host
        # view of the fetched words IS the frame bytes / u16 pixels)
        return temporal._interleave_words_jax(
            folded, channels=(2 if inner == "u16" else channels),
            u16=inner == "u16", cs=color.CS_IDENTITY)

    def make(s, fold):
        _fr, _st, p, mv = s
        return lambda: step(p.words, p.offsets, p.t1, p.t2, mv, fold=fold)

    decodes = [make(s, True) for s in sets]
    plains = [make(s, False) for s in sets]
    label = inner + ("+mc" if motion else "")
    for v, (s, d) in enumerate(zip(sets, decodes)):
        t0 = time.perf_counter()
        out = np.asarray(d())
        if inner == "gray":
            # gray production output is packed words; the host byte view
            # is free (exactly what _decode_temporal_device fetches)
            out = out.view(np.uint8).reshape(
                frames, rows_pf, w_pad)[:, :height, :width]
        elif inner == "u16":
            out = out.view("<u2").reshape(
                frames, rows_pf, w_pad)[:, :height, :width]
        else:
            out = out.view(np.uint8).reshape(
                frames, rows_pf, w_pad, channels)[:, :height, :width, :]
        print(f"variant {v} first decode+fold+fetch "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
        if not np.array_equal(out, s[0]):
            print(f"FATAL: temporal[{label}] decode mismatch on variant {v}",
                  file=sys.stderr)
            sys.exit(1)
    for d in plains + decodes:
        _barrier(d())

    def timed(seq, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = None
            for d in seq:
                r = d()
            _barrier(r)
            times.append(time.perf_counter() - t0)
        return times

    rates = sorted(
        base.nbytes * iters / t / 1e9
        for t in timed([decodes[i % variants] for i in range(iters)]))
    gbps = rates[len(rates) // 2]
    spread = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    plain_rates = sorted(
        base.nbytes * iters / t / 1e9
        for t in timed([plains[i % variants] for i in range(iters)], reps=3))
    plain_gbps = plain_rates[len(plain_rates) // 2]
    print(f"per-rep GB/s (n={len(rates)}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread:.1f}%", file=sys.stderr)
    if verbose:
        ratio = sets[0][1].compressed_size / base.nbytes
        moving = ""
        if motion:
            mv0 = np.asarray(sets[0][3])
            moving = f"  moving={int((mv0 != 0).any(axis=1).sum())}/{frames}"
        print(
            f"device={jax.devices()[0].device_kind} frames={frames} "
            f"frame={height}x{width} keyint={keyint} content={content} "
            f"inner={label}{moving}\n"
            f"encode(host)={t_enc:.2f} s  "
            f"compressed={sets[0][1].compressed_size} B ({ratio:.1%})\n"
            f"MHVT[{label}] decode+fold={gbps:.2f} GB/s  plane/byte "
            f"decode={plain_gbps:.2f} GB/s  fold cost="
            f"{plain_gbps / gbps:.2f}x",
            file=sys.stderr,
        )
    return gbps, len(rates), spread


def run_encode(height: int, width: int, frames: int, iters: int,
               verbose: bool, content: str = "synthetic"):
    """Encode benchmark: host MT encoder + the hybrid device path's stages.

    Reports the production end-to-end rate (the multithreaded C++ encoder)
    and, as diagnostics, the hybrid stage rates: the device stage-1 packer
    (``encode_device.pack_rows``, device-resident timing), the C++ stage-2
    row merge, and the hybrid end to end including its transfers.
    """
    import jax

    from metalhuffman import native
    from metalhuffman.core import blocks as blocks_mod
    from metalhuffman.core import delta as delta_mod
    from metalhuffman.ops import encode_device

    if content == "photo":
        base = photo_frames(height, width, frames)
    else:
        base = np.stack([synthetic_frame(height, width, seed=0, phase=i)
                         for i in range(frames)])
    blk = np.concatenate([blocks_mod.image_to_blocks(f) for f in base])
    syms = delta_mod.delta_encode_blocks(blk).reshape(-1)
    payload = syms.size

    # production host path (multithreaded C++): median of 3 reps + spread
    native.encode_symbols(syms)  # warm (lazy lib build)
    host_rates = []
    for _rep in range(3):
        t0 = time.perf_counter()
        for _ in range(max(1, iters // 8)):
            enc = native.encode_symbols(syms)
        host_rates.append(
            payload * max(1, iters // 8) / (time.perf_counter() - t0) / 1e9)
    host_rates.sort()
    host_gbps = host_rates[len(host_rates) // 2]
    host_spread = (100.0 * (host_rates[-1] - host_rates[0]) / host_gbps
                   if host_gbps else 0.0)

    # hybrid stage 1: device packer, device-resident timing with distinct
    # inputs (two symbol rotations; same table/wmax)
    widths = native.code_lengths(np.bincount(syms, minlength=256).astype(np.int64))
    codes = native.canonical_codes(widths)
    bits_pb = (widths[syms].reshape(-1, 64).astype(np.uint32)
               .sum(axis=1, dtype=np.uint32))
    wmax = int(bits_pb.max()) // 32 + 2
    n_blocks = payload // 64
    cw = [jax.device_put(t.astype(np.int32)) for t in (codes, widths)]
    staged = [jax.device_put(np.roll(syms, roll).reshape(n_blocks, 64))
              for roll in (0, 64)]
    min_w, max_w = encode_device.used_width_band(widths)  # ranged deposit

    def pack(st):
        return encode_device.pack_rows(st, *cw, wmax=wmax, min_w=min_w,
                                       max_w=max_w)

    outs = [pack(st) for st in staged]
    _barrier(outs)
    t0 = time.perf_counter()
    r = None
    for i in range(iters):
        r = pack(staged[i % 2])
    _barrier(r)
    stage1_gbps = payload * iters / (time.perf_counter() - t0) / 1e9

    # hybrid stage 2: host row merge (rows fetched once; fetch not timed)
    rows = np.asarray(outs[0][:, :wmax]).view(np.uint32)
    native.merge_rows(rows, bits_pb)  # warm
    t0 = time.perf_counter()
    for _ in range(max(1, iters // 8)):
        code, offsets, total_bits = native.merge_rows(rows, bits_pb)
    merge_gbps = payload * max(1, iters // 8) / (time.perf_counter() - t0) / 1e9

    # cross-check: hybrid output byte-identical to the host encoder
    same = (np.array_equal(code, enc.code_bytes)
            and np.array_equal(offsets, enc.block_offsets))
    if not same:
        print("FATAL: hybrid merge differs from host encoder", file=sys.stderr)
        sys.exit(1)

    # end-to-end hybrid (includes the host<->device transfers)
    t0 = time.perf_counter()
    encode_device.encode_symbols_hybrid(syms)
    e2e_gbps = payload / (time.perf_counter() - t0) / 1e9

    if verbose:
        print(
            f"device={jax.devices()[0].device_kind} payload={payload/1e6:.0f} MB "
            f"content={content} wmax={wmax}\n"
            f"host MT encode: {host_gbps:.2f} GB/s (production)\n"
            f"hybrid stage-1 packer (device-resident): {stage1_gbps:.2f} GB/s\n"
            f"hybrid stage-2 C++ merge: {merge_gbps:.2f} GB/s\n"
            f"hybrid end-to-end incl. transfers: {e2e_gbps:.2f} GB/s",
            file=sys.stderr,
        )
    return host_gbps, len(host_rates), host_spread


def run_single(height: int, width: int, backend: str, iters: int, verbose: bool):
    """Per-frame dispatch mode (includes per-dispatch overhead)."""
    import jax

    from metalhuffman.models import CodecConfig, ImageCodec

    img = synthetic_frame(height, width)
    codec = ImageCodec(CodecConfig(backend=backend))
    stream = codec.encode(img)
    prep = codec.prepare(stream, height, width)
    out = np.asarray(codec.decode_step(prep))
    if not np.array_equal(out, img):
        print("FATAL: decode mismatch", file=sys.stderr)
        sys.exit(1)
    r = codec.decode_step(prep)
    _barrier(r)
    rates = []
    for _rep in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = codec.decode_step(prep)
        _barrier(r)
        dt = time.perf_counter() - t0
        rates.append(height * width * iters / dt / 1e9)
    rates.sort()
    gbps = rates[len(rates) // 2]
    spread = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    if verbose:
        print(
            f"single-frame [{backend}]: "
            f"{height*width*iters/gbps/1e9/iters*1e3:.3f} ms/frame "
            f"{gbps:.2f} GB/s median of {len(rates)} "
            f"(incl. dispatch overhead)",
            file=sys.stderr,
        )
    return gbps, len(rates), spread


def main():
    from metalhuffman.utils import runtime

    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1536)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--mode", default="video",
                    choices=["video", "single", "encode", "temporal"])
    ap.add_argument("--content", default="synthetic",
                    choices=["synthetic", "photo"],
                    help="photo = committed real-photo asset, panned per frame")
    ap.add_argument("--variants", type=int, default=4,
                    help="distinct staged input batches round-robined in the "
                         "timed loop")
    ap.add_argument("--precoder", default="delta",
                    choices=["delta", "delta2d"],
                    help="delta2d = 2-D within-block predictor (mode 3): "
                         "smaller streams, reconstructed in the kernel")
    ap.add_argument("--motion", action="store_true",
                    help="temporal mode: motion-compensated packed-words "
                         "fold (row/word rolls + byte rotate + SWAR add)")
    ap.add_argument("--inner", default="gray",
                    choices=["gray", "color", "u16"],
                    help="temporal mode: inner container kind (color/u16 "
                         "measure the words-domain plane-fold + channel-"
                         "interleave chains)")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the timed loop")
    args = ap.parse_args()
    runtime.require_gpu()
    runtime.configure_compile_cache()

    if args.trace:
        import jax

        jax.profiler.start_trace(args.trace)

    metric = "decode_throughput"
    if args.mode == "video":
        gbps, reps, spread = run_video(
            args.height, args.width, args.frames, args.iters,
            args.verbose, content=args.content,
            variants=args.variants, precoder=args.precoder)
    elif args.mode == "temporal":
        if args.motion or args.inner != "gray":
            gbps, reps, spread = run_temporal_ext(
                args.height, args.width, args.frames, args.iters,
                args.verbose, content=args.content, variants=args.variants,
                motion=args.motion, inner=args.inner)
            metric = ("temporal_" + ("mc_" if args.motion else "")
                      + (f"{args.inner}_" if args.inner != "gray" else "")
                      + "decode_throughput")
        else:
            gbps, reps, spread = run_temporal(
                args.height, args.width, args.frames, args.iters,
                args.verbose, content=args.content, variants=args.variants)
            metric = "temporal_decode_throughput"
    elif args.mode == "encode":
        gbps, reps, spread = run_encode(
            args.height, args.width, args.frames, args.iters,
            args.verbose, content=args.content)
        metric = "encode_throughput"
    else:
        gbps, reps, spread = run_single(
            args.height, args.width, args.backend, args.iters, args.verbose)
    if args.trace:
        import jax

        jax.profiler.stop_trace()
        print(f"trace written to {args.trace}", file=sys.stderr)
    # value = MEDIAN of `reps` repetitions; spread_pct = (max-min)/median
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(gbps, 4),
                "unit": "GB/s",
                "vs_baseline": round(gbps / BASELINE_GBPS, 2),
                "reps": reps,
                "spread_pct": round(spread, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
