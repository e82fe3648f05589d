# Copied from path_tracer_tpu/utils/image.py (numpy-only host code shared with the JAX package).
"""Image IO: PNG read/write and Radiance .hdr loading.

The reference loads PNG/HDR through stb_image
(reference src/core/stb_image.h) as float RGBA. Here: PNG via
Pillow when available with a pure-python zlib fallback writer, and an
own Radiance RGBE (.hdr) decoder (RLE + flat scanlines).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_png(path):
    """Load a PNG (or any Pillow-readable image) as (H, W, 4) float32."""
    from PIL import Image

    img = Image.open(path).convert('RGBA')
    arr = np.asarray(img, np.float32) / 255.0
    # sRGB -> linear for color channels, like stb-based loaders feeding a
    # linear pipeline (the reference uploads 8-bit PNGs as UNORM and
    # uplifts the raw values; we match by NOT linearizing here).
    return arr


def encode_png(image, compress_level=6):
    """Encode (H, W, 3|4) float [0,1] image as PNG bytes (pure python)."""
    arr = np.asarray(image)
    if arr.ndim != 3:
        raise ValueError('expected (H, W, C) image')
    h, w, c = arr.shape
    if c == 3:
        arr = np.concatenate([arr, np.ones((h, w, 1), arr.dtype)], -1)
    data = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    raw = b''.join(b'\x00' + data[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        body = tag + payload
        return (struct.pack('>I', len(payload)) + body
                + struct.pack('>I', zlib.crc32(body) & 0xFFFFFFFF))

    png = b'\x89PNG\r\n\x1a\n'
    png += chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 6, 0, 0, 0))
    png += chunk(b'IDAT', zlib.compress(raw, compress_level))
    png += chunk(b'IEND', b'')
    return png


def save_png(path, image):
    """Write (H, W, 3|4) float [0,1] image as PNG (pure python)."""
    with open(path, 'wb') as f:
        f.write(encode_png(image))


def load_hdr(path):
    """Decode a Radiance RGBE (.hdr) file to (H, W, 4) float32.

    Supports the standard -Y H +X W orientation with adaptive RLE or
    flat scanlines (the format stb_image reads for the reference's HDR
    skyboxes).
    """
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if not magic.startswith(b'#?'):
            raise ValueError('not a Radiance HDR file')
        # Header: key=value lines until blank.
        while True:
            line = f.readline()
            if not line:
                raise ValueError('truncated HDR header')
            if line.strip() == b'':
                break
            if line.startswith(b'FORMAT') and b'32-bit_rle_rgbe' not in line:
                raise ValueError('unsupported HDR format')
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b'-Y' or dims[2] != b'+X':
            raise ValueError(f'unsupported HDR orientation: {dims}')
        height, width = int(dims[1]), int(dims[3])

        data = f.read()

    rgbe = np.zeros((height, width, 4), np.uint8)
    pos = 0
    for y in range(height):
        if (width < 8 or width > 0x7FFF or data[pos] != 2 or data[pos + 1] != 2
                or (data[pos + 2] << 8 | data[pos + 3]) != width):
            # Flat scanline.
            row = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            rgbe[y] = row
            pos += width * 4
            continue
        pos += 4
        for c in range(4):
            x = 0
            while x < width:
                count = data[pos]
                pos += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = data[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x:x + count, c] = np.frombuffer(
                        data, np.uint8, count, pos)
                    pos += count
                    x += count

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, exponent - 136).astype(np.float32)  # 2^(e-128-8)
    rgb = mantissa * scale[..., None]
    rgb[exponent == 0] = 0.0
    alpha = np.ones((height, width, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)


def save_hdr(path, image):
    """Write (H, W, 3) float32 as flat (non-RLE) Radiance RGBE."""
    rgb = np.asarray(image, np.float32)[..., :3]
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    valid = maxc > 1e-32
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float64)
    mant[valid], exp[valid] = np.frexp(maxc[valid])
    scale = np.zeros((h, w, 1), np.float32)
    scale[valid, 0] = (mant[valid] * 256.0 / maxc[valid]).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n')
        f.write(f'-Y {h} +X {w}\n'.encode())
        f.write(rgbe.tobytes())
