"""metalhuffman: a canonical Huffman codec framework in JAX for NVIDIA GPUs.

Built from scratch with the capabilities of mdejong/MetalHuffman (GPU Huffman
decode demo for Metal):

- ``core``: CPU codec core (canonical codes, bitstream, LUTs, delta, container).
- ``native``: C++ fast-path codec library with ctypes bindings.
- ``ops``: device paths — the Pallas decode kernel (Triton route), the plain
  XLA decode and encode.
- ``parallel``: mesh/sharding utilities for multi-device / multi-host decode.
- ``models``: end-to-end codec pipelines (grayscale image codec, frame streams).
- ``utils``: fixtures (test frames), PNG/TGA IO, profiling helpers.
"""

__version__ = "0.1.0"


def encode_image(img, config=None) -> bytes:
    """Convenience: (H, W) uint8 grayscale image -> MHT1 container bytes."""
    from .models import ImageCodec

    return ImageCodec(config).encode_to_bytes(img)


def decode_image(blob: bytes, config=None):
    """Convenience: MHT1 container bytes -> (H, W) uint8 image (CRC-checked)."""
    from .models import ImageCodec

    return ImageCodec(config).decode(blob)


def encode_color_image(img, config=None) -> bytes:
    """Convenience: (H, W, C) uint8 -> MHTC color container bytes."""
    from .models import color

    return color.encode_color_to_bytes(img, config)


def decode_color_image(blob: bytes, config=None):
    """Convenience: MHTC color container -> (H, W, C) uint8 (CRC-checked)."""
    from .models import color

    return color.decode_color_from_bytes(blob, config)


def encode_color_video(frames, config=None) -> bytes:
    """Convenience: (T, H, W, C) uint8 -> MHTC color video container.

    With ``config.temporal`` the frames become inter-frame residuals in an
    MHVT wrapper (keyframe every ``config.keyint``)."""
    from .models import color

    if config is not None and config.temporal:
        from .models import temporal

        return temporal.encode_temporal_color_video(frames, config)
    return color.encode_color_video_to_bytes(frames, config)


def decode_color_video(blob: bytes, config=None):
    """Convenience: MHTC (or temporal MHVT) color video -> (T, H, W, C) uint8."""
    from .models import color

    if blob[:4] == b"MHVT":
        from .models import temporal

        return temporal.decode_temporal_video(blob, config)
    return color.decode_color_video_from_bytes(blob, config)


def encode_video(frames, config=None) -> bytes:
    """Convenience: (T, H, W) uint8 frames -> MHTV container, auto-upgrading
    to segmented MHV2 when the stream could overflow u32 block offsets.

    Records the source payload CRC-32 so decoders can verify end-to-end
    (the trailer catches length-preserving corruption the on-device
    end-bit check cannot)."""
    import zlib

    import numpy as np

    from .models import frame_stream

    frames_arr = np.asarray(frames)
    if config is not None and config.temporal:
        from .models import temporal

        return temporal.encode_temporal_video(frames_arr, config)
    t, h, w = frames_arr.shape
    crc = zlib.crc32(np.ascontiguousarray(frames_arr).tobytes())
    fcrcs = None
    if config is not None and config.frame_crcs:
        # per-frame table (FCRC extension): random access verifies exactly
        # the frames it touches
        fcrcs = frame_stream.compute_frame_crcs(frames_arr)
    segs = frame_stream.encode_frames_segmented(frames_arr, config)
    if len(segs) == 1:
        return frame_stream.write_shared(
            segs[0][0], t, h, w, config, source_crc32=crc, frame_crcs=fcrcs)
    return frame_stream.write_segmented(segs, h, w, config, source_crc32=crc,
                                        frame_crcs=fcrcs)


def decode_video(blob: bytes, config=None):
    """Convenience: MHTV/MHV2 (or temporal MHVT) container bytes ->
    (T, H, W) uint8 frames.

    The container's recorded block_dim/delta are authoritative; config
    selects the backend only. When the container records a source CRC-32
    the decoded payload is verified against it (ValueError on mismatch).
    An MHVT container returns the reconstructed true frames (shape/dtype
    follow its inner container — color MHVT yields (T, H, W, C)).
    """
    import dataclasses

    import numpy as np

    from .models import CodecConfig, frame_stream

    if blob[:4] == b"MHVT":
        from .models import temporal

        return temporal.decode_temporal_video(blob, config)
    if blob[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, _t, h, w, bd, delta = frame_stream.read_segmented(blob)
        cfg = dataclasses.replace(
            config or CodecConfig(), block_dim=bd, delta=delta,
            delta2d=bool(segs) and segs[0][0].predictor == "2d")
        frames = frame_stream.decode_frames_segmented(segs, h, w, cfg)
    else:
        stream, t, h, w, bd, delta = frame_stream.read_shared(blob)
        cfg = dataclasses.replace(
            config or CodecConfig(), block_dim=bd, delta=delta,
            delta2d=stream.predictor == "2d")
        frames = np.asarray(
            frame_stream.decode_frames_shared(stream, t, h, w, cfg))
    frame_stream.verify_source_crc32(frames, frame_stream.source_crc32(blob))
    return frames
