"""Image I/O helpers.

Analog of the reference's stb usage (reference: CudaRayTracer/src/Utils/
RawStbImage.h:12-22 for loading; the reference cannot save renders at all —
offline PNG output is an improvement).  PNG encoding uses only the standard
library (zlib + struct); reading image files (JPEG texture uploads and
``load_rgb``) needs Pillow, an optional extra (``pip install
cudaraytracer-tpu[images]``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 [H,W,3] (RGB) or [H,W,4] (RGBA) image, row 0
    at the top.  8-bit truecolor, every scanline unfiltered (filter 0)."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected HxWx3 or HxWx4 uint8, got {arr.shape}")
    h, w, c = arr.shape
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = arr.reshape(h, w * c)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    color_type = 6 if c == 4 else 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def require_pillow(what: str):
    """Import Pillow's Image module, or fail naming the optional extra."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{what} needs Pillow, which is not installed: pip install "
            "pillow (or the package's [images] extra)") from None
    return Image


def save_png(path: str, image: np.ndarray, flip_vertical: bool = True):
    """Save an RGB(A) uint8 or float [0,1] image as PNG at ``path``.

    ``flip_vertical`` converts framebuffer order (row 0 = bottom, the
    reference's GL convention — it flips at display time with uv coords,
    CudaLayer.cpp:402) to standard image order.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if flip_vertical:
        arr = arr[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def save_pfm(path, radiance: np.ndarray):
    """Save LINEAR float radiance as a color PFM (portable float map) —
    the HDR export for compositing pipelines.  PFM rows are stored
    bottom-up by spec, so a display-oriented (row 0 = top) input is
    flipped on write; scale -1.0 = little-endian float32.  ``path`` is a
    filesystem path or a binary file-like (the viewer's /radiance.pfm)."""
    arr = np.asarray(radiance, np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected HxWx3 radiance, got {arr.shape}")
    f = path if hasattr(path, "write") else open(path, "wb")
    try:
        f.write(b"PF\n%d %d\n-1.0\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr[::-1].astype("<f4").tobytes())
    finally:
        if f is not path:
            f.close()


def load_pfm(path: str) -> np.ndarray:
    """Read a color PFM back to display-oriented f32[H,W,3]."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError("not a color PFM")
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 12),
                             "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].astype(np.float32)


def load_rgb(path: str) -> np.ndarray:
    """uint8[H,W,3] from any common image file (stbi_load analog)."""
    Image = require_pillow("reading image files")
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)
