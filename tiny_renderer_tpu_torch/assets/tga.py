"""TGA decoder with `image`-crate-equivalent output semantics.

The reference loads its four texture maps with
``image::open(path)?.into_rgb8()`` (reference: src/app.rs:99-131).  The asset
files are 1024x1024 Truevision TGA, RLE-compressed (types 10/11), at 8, 24 or
32 bpp, bottom-left origin.  To match the reference pixel-for-pixel this
decoder reproduces what the `image` crate produces:

* rows are returned top-to-bottom (bottom-left-origin files are flipped),
* 24 bpp BGR -> RGB, 32 bpp BGRA -> RGB (alpha dropped, as `into_rgb8` does),
* 8 bpp grayscale -> RGB by channel replication,
* 15/16 bpp A1RGB5 channels are expanded to 8 bits with round(c * 255 / 31).

Pure NumPy; the optional native C++ loader (tiny_renderer_tpu.assets.native)
implements the identical layout for the hot path and is cross-checked against
this implementation in tests.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<BBBHHBHHHHBB")

# Image types.
_NO_IMAGE = 0
_COLORMAP = 1
_TRUECOLOR = 2
_GRAYSCALE = 3
_RLE_COLORMAP = 9
_RLE_TRUECOLOR = 10
_RLE_GRAYSCALE = 11


def _decode_rle(data: memoryview, num_pixels: int, bytes_per_pixel: int) -> np.ndarray:
    """Decode TGA run-length packets into a flat (num_pixels, bpp) u8 array."""
    out = np.empty(num_pixels * bytes_per_pixel, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    pos = 0
    written = 0
    total = num_pixels * bytes_per_pixel
    while written < total:
        packet = src[pos]
        pos += 1
        count = (int(packet) & 0x7F) + 1
        if packet & 0x80:  # RLE packet: one pixel value repeated `count` times
            pixel = src[pos : pos + bytes_per_pixel]
            pos += bytes_per_pixel
            n = count * bytes_per_pixel
            out[written : written + n] = np.tile(pixel, count)
            written += n
        else:  # raw packet: `count` literal pixels
            n = count * bytes_per_pixel
            out[written : written + n] = src[pos : pos + n]
            pos += n
            written += n
    return out.reshape(num_pixels, bytes_per_pixel)


def _expand_channels(pixels: np.ndarray, bpp: int) -> np.ndarray:
    """(N, bytes) raw pixels -> (N, 3) RGB u8, image-crate channel order."""
    if bpp == 8:
        return np.repeat(pixels, 3, axis=1)
    if bpp == 24:  # BGR
        return pixels[:, [2, 1, 0]]
    if bpp == 32:  # BGRA -> drop alpha
        return pixels[:, [2, 1, 0]]
    if bpp in (15, 16):  # GGGBBBBB ARRRRRGG little-endian
        v = pixels[:, 0].astype(np.uint16) | (pixels[:, 1].astype(np.uint16) << 8)
        r = (v >> 10) & 0x1F
        g = (v >> 5) & 0x1F
        b = v & 0x1F
        rgb5 = np.stack([r, g, b], axis=1).astype(np.float32)
        return np.round(rgb5 * (255.0 / 31.0)).astype(np.uint8)
    raise ValueError(f"unsupported TGA bit depth: {bpp}")


def decode_tga(buf: bytes) -> np.ndarray:
    """Decode a TGA byte buffer into an (H, W, 3) RGB u8 array, top-left origin."""
    if len(buf) < _HEADER.size:
        raise ValueError("TGA file truncated (no header)")
    (
        id_len,
        cmap_type,
        img_type,
        cmap_first,
        cmap_len,
        cmap_bpp,
        _x0,
        _y0,
        width,
        height,
        bpp,
        desc,
    ) = _HEADER.unpack_from(buf, 0)

    if img_type == _NO_IMAGE:
        raise ValueError("TGA contains no image data")
    pos = _HEADER.size + id_len

    cmap = None
    if cmap_type == 1:
        cmap_entry_bytes = (cmap_bpp + 7) // 8
        raw = np.frombuffer(buf, dtype=np.uint8, count=cmap_len * cmap_entry_bytes, offset=pos)
        pos += cmap_len * cmap_entry_bytes
        cmap = _expand_channels(raw.reshape(cmap_len, cmap_entry_bytes), cmap_bpp)

    num_pixels = width * height
    bytes_per_pixel = (bpp + 7) // 8

    body = memoryview(buf)[pos:]
    if img_type in (_RLE_TRUECOLOR, _RLE_GRAYSCALE, _RLE_COLORMAP):
        pixels = _decode_rle(body, num_pixels, bytes_per_pixel)
    elif img_type in (_TRUECOLOR, _GRAYSCALE, _COLORMAP):
        flat = np.frombuffer(body, dtype=np.uint8, count=num_pixels * bytes_per_pixel)
        pixels = flat.reshape(num_pixels, bytes_per_pixel)
    else:
        raise ValueError(f"unsupported TGA image type: {img_type}")

    if img_type in (_COLORMAP, _RLE_COLORMAP):
        if cmap is None:
            raise ValueError("colormapped TGA without a colormap")
        indices = pixels[:, 0].astype(np.int64) - cmap_first
        rgb = cmap[indices]
    else:
        rgb = _expand_channels(pixels, bpp)

    img = rgb.reshape(height, width, 3)
    if not (desc & 0x20):  # origin bit clear -> bottom-left -> flip to top-left
        img = img[::-1]
    if desc & 0x10:  # right-to-left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tga(f.read())
