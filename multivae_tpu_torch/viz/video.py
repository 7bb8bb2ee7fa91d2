"""Dependency-free video output: an MJPEG-in-AVI writer.

A copy of ``multivae_tpu/viz/video.py`` (numpy; Pillow encodes the JPEGs).
The reference renders its avatar-traverse animation to mp4 through
matplotlib's ffmpeg writer (``workflow.py:1242-1373``). This image has no
ffmpeg binary, so an mp4 muxer is unavailable — but a Motion-JPEG AVI needs
only a RIFF container around per-frame JPEG payloads (Pillow encodes the
JPEGs), and every mainstream player (VLC, mpv, ffplay, QuickTime, Windows
Media Player, web ``<video>`` via most OS codecs) decodes MJPG AVIs. The
container is written by hand below: ``RIFF('AVI ', LIST('hdrl', avih,
LIST('strl', strh, strf)), LIST('movi', '00dc'...), idx1)`` per the
classic AVIMAINHEADER/AVISTREAMHEADER/BITMAPINFOHEADER layout.
"""

from __future__ import annotations

import io
import struct
from typing import Sequence

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame), "RGB").save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: Sequence[np.ndarray], fps: int = 4,
                    quality: int = 90) -> str:
    """Write uint8 RGB ``[H, W, 3]`` frames as a Motion-JPEG AVI.

    All frames must share one shape. Returns ``path``.
    """
    if len(frames) == 0:
        raise ValueError("write_mjpeg_avi needs at least one frame")
    first = np.asarray(frames[0])
    if first.ndim != 3:
        raise ValueError(f"every frame must be a [H, W, 3] array; got "
                         f"shape {first.shape}")
    h, w = first.shape[:2]
    payloads = []
    for f in frames:
        f = np.asarray(f)
        if f.ndim != 3 or f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(
                f"every frame must be uint8 [{h}, {w}, 3]; got "
                f"{f.dtype} {f.shape}")
        payloads.append(_jpeg_bytes(f, quality))
    n = len(payloads)
    max_bytes = max(len(p) for p in payloads)

    avih = struct.pack(
        "<14I",
        int(1_000_000 // fps),          # dwMicroSecPerFrame
        max_bytes * fps,                # dwMaxBytesPerSec
        0,                              # dwPaddingGranularity
        AVIF_HASINDEX,                  # dwFlags
        n,                              # dwTotalFrames
        0,                              # dwInitialFrames
        1,                              # dwStreams
        max_bytes,                      # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0)               # dwWidth, dwHeight, reserved[4]
    strh = struct.pack(
        "<4s4s10I4h",
        b"vids", b"MJPG",
        0, 0, 0,                        # flags, priority+language, initial
        1, fps,                         # dwScale, dwRate (fps = rate/scale)
        0, n,                           # dwStart, dwLength (frames)
        max_bytes,                      # dwSuggestedBufferSize
        0xFFFFFFFF, 0,                  # dwQuality (-1), dwSampleSize
        0, 0, w, h)                     # rcFrame
    strf = struct.pack(
        "<I2i2H2I2i2I",
        40, w, h, 1, 24,                # biSize..biBitCount
        0x47504A4D,                     # biCompression = 'MJPG'
        w * h * 3, 0, 0, 0, 0)          # biSizeImage, rest zero

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) % 2 else b""
        return fourcc + struct.pack("<I", len(data)) + data + pad

    def lst(kind: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", kind + data)

    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_parts, index_parts, off = [], [], 4
    for p in payloads:
        # index offsets count from the 'movi' fourcc position
        index_parts.append(struct.pack("<4s3I", b"00dc", AVIIF_KEYFRAME,
                                       off, len(p)))
        part = chunk(b"00dc", p)
        movi_parts.append(part)
        off += len(part)
    movi = lst(b"movi", b"".join(movi_parts))
    idx1 = chunk(b"idx1", b"".join(index_parts))
    riff = chunk(b"RIFF", b"AVI " + hdrl + movi + idx1)
    with open(path, "wb") as fh:
        fh.write(riff)
    return path


def figure_to_rgb(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to a uint8 RGB array."""
    fig.canvas.draw()
    rgba = np.asarray(fig.canvas.buffer_rgba())
    return rgba[..., :3].copy()
