"""Minimal dependency-free PNG writer (RGB8, zlib filter 0)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) u8 array as PNG bytes (in-memory sibling of
    write_png — serving paths hand these straight to a socket)."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) u8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw, 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) u8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def downsample_box(image: np.ndarray, n: int) -> np.ndarray:
    """Box-average an (H, W, C) u8 image by an integer factor n (SSAA
    resolve: render at n x supersampling, average each n x n block back
    to one pixel).  Rounded-to-nearest integer average — deterministic,
    no float paths."""
    if n <= 1:
        return image
    h, w, c = image.shape
    if h % n or w % n:
        raise ValueError(f"image {h}x{w} not divisible by ssaa factor {n}")
    blocks = image.reshape(h // n, n, w // n, n, c).astype(np.uint32)
    total = blocks.sum(axis=(1, 3))
    return ((total + n * n // 2) // (n * n)).astype(np.uint8)
