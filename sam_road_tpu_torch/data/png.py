"""8-bit PNG reading and writing with zlib (the counterpart of the
cv2.imread / cv2.imwrite calls in sam_road_tpu/data/dataset.py and
sam_road_tpu/utils/viz.py; the GPU machine has neither cv2 nor PIL).

read_png decodes non-interlaced 8-bit grayscale, RGB and RGBA images into
what cv2.imread gives after its BGR -> RGB swap: [H, W] for grayscale,
[H, W, 3] RGB otherwise, the alpha channel dropped. It raises on every other
kind (16-bit, palette, gray + alpha, interlaced). The row filters are undone
in C++ (csrc/png_unfilter.cc, built with g++ at first use; a failed build
raises): the Average and Paeth filters that libpng's adaptive filtering
emits are serial along a row. unfilter_plain is the same in numpy, for the
tests. write_png writes filter type 0 (None) on every row.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib

import numpy as np

from sam_road_tpu_torch._native import PKG_DIR, build_and_load

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> bytes per pixel: gray, RGB, RGBA


@functools.cache
def _lib():
    dll = build_and_load(
        "samroad_png", "g++", ["-O3", "-shared", "-fPIC", "-std=c++17"],
        [os.path.join(PKG_DIR, "csrc", "png_unfilter.cc")])
    dll.samroad_png_unfilter.restype = ctypes.c_int64
    dll.samroad_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_void_p]
    return dll


def chunk(kind: bytes, body: bytes) -> bytes:
    """One PNG chunk: length, type, body, CRC-32 of type and body."""
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = data[pos + 8:end - 4]
        if struct.unpack(">I", data[end - 4:end])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: {kind!r} chunk fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: no IEND chunk")


def unfilter(rows, bpp: int):
    """[H, 1 + row_bytes] filtered rows -> [H, row_bytes] uint8 (C++)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, w = rows.shape
    out = np.empty((h, w - 1), np.uint8)
    bad = _lib().samroad_png_unfilter(rows.ctypes.data, h, w - 1, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has unknown filter type {rows[bad - 1, 0]}")
    return out


def unfilter_plain(rows, bpp: int):
    """The same as unfilter, row by row in numpy (Average and Paeth byte by
    byte): the reference the tests hold the C++ version to."""
    rows = np.asarray(rows, dtype=np.uint8)
    h, w = rows.shape
    out = np.zeros((h, w - 1), np.uint8)
    prev = np.zeros(w - 1, np.int64)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 1:
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:
            cur = (cur + prev) & 255
        elif kind in (3, 4):
            for x in range(w - 1):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        elif kind != 0:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str):
    """An 8-bit grayscale ([H, W]), RGB or RGBA ([H, W, 3], alpha dropped)
    PNG as uint8, in RGB order."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filter_method or interlace:
        raise ValueError(
            f"{path}: reads only non-interlaced 8-bit grayscale, RGB and RGBA PNGs, got bit "
            f"depth {depth}, color type {color}, interlace {interlace}")
    bpp = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (1 + width * bpp):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, expected "
                         f"{height * (1 + width * bpp)}")
    img = unfilter(np.frombuffer(raw, np.uint8).reshape(height, 1 + width * bpp), bpp)
    img = img.reshape(height, width, bpp)
    return img[..., 0] if bpp == 1 else np.ascontiguousarray(img[..., :3])


def write_png(path: str, array) -> None:
    """Write uint8 [H, W] (grayscale), [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    as a PNG with filter type 0 on every row."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    data = (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
