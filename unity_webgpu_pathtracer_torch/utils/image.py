"""Dependency-free image IO (``utils/image.py`` of the reference): a small
PNG codec on zlib for LDR output and texture maps, and a Radiance ``.hdr``
(RGBE) reader and writer for HDRI environment maps.  numpy only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3|4) uint8 or float image (floats clipped to [0,1])
    as PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    color_type = 2 if c == 3 else 6
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 or float image (floats are clipped to [0,1])."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8-bit RGB/RGBA/gray, filters 0-4. Returns uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(data: bytes) -> np.ndarray:
    """``read_png`` on the file's bytes."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, meta = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            meta = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = meta
    if depth != 8 or interlace != 0:
        raise ValueError("only 8-bit non-interlaced PNG supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], dtype=np.uint8).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub / Average / Paeth need sequential left-neighbor scans
            cur = np.zeros(stride, dtype=np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                if filt == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif filt == 3:
                    cur[x] = (line[x] + ((a + b) >> 1)) & 0xFF
                elif filt == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[x] = (line[x] + pred) & 0xFF
                else:
                    raise ValueError(f"bad filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = out[y]
    return out.reshape(h, w, channels)


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr)
# ---------------------------------------------------------------------------

def write_hdr(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float32 image as uncompressed Radiance RGBE."""
    img = np.asarray(image, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), dtype=np.int32)
    mant = np.zeros((h, w), dtype=np.float32)
    nz = maxc > 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, mant * 256.0 / np.where(nz, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file (flat or adaptive-RLE scanlines) -> (H,W,3) f32."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].decode().split()
    h, w = int(dims[1]), int(dims[3])
    payload = data[eol + 1 :]
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    p = 0
    for y in range(h):
        if w >= 8 and w < 32768 and payload[p] == 2 and payload[p + 1] == 2:
            # Adaptive RLE scanline
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[p]
                    p += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = payload[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            payload[p : p + count], dtype=np.uint8
                        )
                        p += count
                        x += count
        else:
            line = np.frombuffer(payload[p : p + 4 * w], dtype=np.uint8).reshape(w, 4)
            rgbe[y] = line
            p += 4 * w
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
