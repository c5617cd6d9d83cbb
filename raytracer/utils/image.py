"""Image IO: gamma-2 encode + PNG save (vec3.rs:223-231, main.rs:55).

Prefers the native C++ PNG encoder (native/rt_native.cpp) when built;
falls back to Pillow, then to a pure-Python minimal PNG writer.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from raytracer.ops import vec


def linear_to_rgb8(img_linear) -> np.ndarray:
    """(H,W,3) linear float -> (H,W,3) uint8 with gamma-2 (vec3.rs:223-231)."""
    return np.asarray(vec.to_rgb8(img_linear))


def save_png(path: str, rgb8: np.ndarray):
    """Write an (H,W,3) uint8 array as PNG."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from raytracer.native import runtime as native_rt
        if native_rt.available() and native_rt.write_png(path, rgb8):
            return
    except Exception:
        pass
    try:
        from PIL import Image
        Image.fromarray(rgb8, "RGB").save(path)
        return
    except Exception:
        pass
    _write_png_python(path, rgb8)


def save_render(path: str, img_linear):
    save_png(path, linear_to_rgb8(img_linear))


def _write_png_python(path: str, rgb8: np.ndarray):
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
