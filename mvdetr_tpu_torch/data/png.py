"""PNG codec on the standard library's ``zlib`` and the port's native library.

The card's machine has neither cv2 nor PIL, so the port reads and writes
the lossless frames of a Wildtrack-format tree itself (the JAX package's
``mvdetr_tpu/data/dataset.py:36-50`` reads them through cv2 or PIL).
PNG is lossless: any correct decoder gives the same bytes, so this one
gives cv2's and PIL's on every machine.

- :func:`decode_png`: 8-bit, non-interlaced PNGs of colour type 0 (grey),
  2 (RGB), 4 (grey + alpha) and 6 (RGBA) -> ``uint8 [H, W, 3]`` RGB. Grey
  is replicated to three channels and alpha dropped, as
  ``cv2.imread(path, cv2.IMREAD_COLOR)`` and PIL's ``convert("RGB")`` do.
  The signature and every chunk's CRC are checked and the ``IDAT`` chunks
  joined; ``zlib.decompress`` inflates them and
  :func:`mvdetr_tpu_torch.native.png_unfilter` undoes the row filters
  (both release the interpreter lock, so the loader's threads decode in
  parallel). Palette, 16-bit and interlaced files raise ``ValueError``
  naming what is unsupported; nothing hands a file to another decoder.
- :func:`encode_png`: ``uint8 [H, W]`` (grey), ``[H, W, 3]`` or
  ``[H, W, 4]`` -> PNG bytes, every row filter 0 (None), ``zlib.compress``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mvdetr_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels; 3 (palette) is not supported
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def read_chunks(data: bytes):
    """``(type, payload)`` of every chunk up to ``IEND``, each CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file: the 8-byte signature does not match")
    pos, end = 8, len(data)
    while pos + 12 <= end:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > end:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC check (corrupt file)")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def decode_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG file (a path, or its bytes) to ``uint8 [H, W, 3]`` RGB."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    header, idat = None, []
    for kind, payload in read_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in CHANNELS:
        name = COLOUR_NAMES.get(colour, f"colour type {colour}")
        raise ValueError(f"unsupported PNG: {name} images are not supported (colour types 0, 2, 4 and 6 are)")
    if depth != 8:
        raise ValueError(f"unsupported PNG: {depth}-bit samples (only 8-bit)")
    if interlace != 0:
        raise ValueError("unsupported PNG: interlaced (Adam7) images (only non-interlaced)")
    if compression != 0 or filtering != 0:
        raise ValueError(f"unsupported PNG: compression method {compression}, filter method {filtering}")
    channels = CHANNELS[colour]
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    pixels = rows.reshape(height, width, channels)
    if channels <= 2:  # grey, alpha dropped, to three channels
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a ``uint8`` image: ``[H, W]`` grey, ``[H, W, 3]`` RGB or
    ``[H, W, 4]`` RGBA; filter 0 on every row, deflate at ``level``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    colour = {1: 0, 3: 2, 4: 6}.get(img.shape[2]) if img.ndim == 3 else None
    if colour is None:
        raise ValueError(f"encode_png: expected [H, W], [H, W, 3] or [H, W, 4], got {img.shape}")
    height, width = img.shape[:2]
    raw = np.zeros((height, 1 + width * img.shape[2]), dtype=np.uint8)  # column 0: filter type 0
    raw[:, 1:] = img.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """:func:`encode_png` into ``path``."""
    data = encode_png(img, level)
    with open(path, "wb") as fh:
        fh.write(data)
