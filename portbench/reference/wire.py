"""Plain reference of the BaF2 wire container with the ``raw`` backend.

A container is: the magic ``BaF2``, the backend id (``raw`` is 2), the bit
depth and the number of dimensions (one byte each), the coded stream's
shape (uint32 each), the side-info and payload lengths (uint32 each), the
side info (every fp16 min, then every fp16 max) and the payload: the codes
packed ``bits`` each, little-endian, least significant bit first. All
integers are little-endian.

A power-of-two C travels as a 2D image, channel k in tile
``(k // cols, k % cols)`` of a ``rows x cols`` grid (rows = 2^(lg C // 2),
cols = 2^((lg C + 1) // 2)), one image per example stacked on the rows;
any other C travels channel-last (B, H, W, C).
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"BaF2"
RAW_ID = 2


def tiled(c: int) -> bool:
    return c >= 1 and c & (c - 1) == 0


def grid(c: int) -> tuple[int, int]:
    lg = c.bit_length() - 1
    return 1 << (lg // 2), 1 << ((lg + 1) // 2)


def to_stream(codes: np.ndarray) -> np.ndarray:
    """(B, H, W, C) codes -> the coded stream (tiled 2D image or as is)."""
    b, h, w, c = codes.shape
    if not tiled(c):
        return codes
    rows, cols = grid(c)
    out = np.empty((b, rows * h, cols * w), codes.dtype)
    for k in range(c):
        r, q = divmod(k, cols)
        out[:, r * h:(r + 1) * h, q * w:(q + 1) * w] = codes[..., k]
    return out.reshape(b * rows * h, cols * w)


def from_stream(stream: np.ndarray, shape: tuple) -> np.ndarray:
    """The coded stream -> (B, H, W, C) codes of ``shape``."""
    b, h, w, c = shape
    if not tiled(c):
        return stream.reshape(shape)
    rows, cols = grid(c)
    img = stream.reshape(b, rows * h, cols * w)
    out = np.empty(shape, stream.dtype)
    for k in range(c):
        r, q = divmod(k, cols)
        out[..., k] = img[:, r * h:(r + 1) * h, q * w:(q + 1) * w]
    return out


def pack(codes: np.ndarray, bits: int) -> bytes:
    """Codes packed ``bits`` each, LSB first, in C order."""
    flat = np.asarray(codes, np.uint64).ravel()
    bitplanes = (flat[:, None] >> np.arange(bits, dtype=np.uint64)) & 1
    return np.packbits(bitplanes.astype(np.uint8).ravel(),
                       bitorder="little").tobytes()


def unpack(payload: bytes, bits: int, count: int) -> np.ndarray:
    raw = np.unpackbits(np.frombuffer(payload, np.uint8),
                        bitorder="little")[:count * bits]
    planes = raw.reshape(count, bits).astype(np.int64)
    return (planes << np.arange(bits, dtype=np.int64)).sum(axis=1)


def write(codes: np.ndarray, mins: np.ndarray, maxs: np.ndarray,
          bits: int) -> bytes:
    """(B, H, W, C) codes with (B, C) fp16 side info -> container bytes."""
    stream = to_stream(codes)
    side = (np.asarray(mins, np.float16).tobytes()
            + np.asarray(maxs, np.float16).tobytes())
    payload = pack(stream, bits)
    hdr = struct.pack("<4sBBB", MAGIC, RAW_ID, bits, stream.ndim)
    hdr += struct.pack(f"<{stream.ndim}I", *stream.shape)
    hdr += struct.pack("<II", len(side), len(payload))
    return hdr + side + payload


class WireError(ValueError):
    """A container that is not the expected raw container of its request."""


def read(data: bytes, shape: tuple, bits: int):
    """Container bytes of one request with codes of ``shape`` (B, H, W, C)
    -> (codes int64 (B, H, W, C), mins, maxs (B, C) fp16). Raises
    :class:`WireError` on any field that departs from what ``shape`` and
    ``bits`` fix."""
    b, h, w, c = shape
    want = (b * grid(c)[0] * h, grid(c)[1] * w) if tiled(c) else tuple(shape)
    magic, backend, nbits, ndim = struct.unpack_from("<4sBBB", data, 0)
    if (magic, backend, nbits, ndim) != (MAGIC, RAW_ID, bits, len(want)):
        raise WireError(f"header {(magic, backend, nbits, ndim)}")
    off = 7
    got = struct.unpack_from(f"<{ndim}I", data, off)
    off += 4 * ndim
    silen, plen = struct.unpack_from("<II", data, off)
    off += 8
    count = int(np.prod(want))
    if got != want or silen != 4 * b * c or plen != -(-count * bits // 8) \
            or len(data) != off + silen + plen:
        raise WireError(f"shape {got}, side info {silen} B, payload {plen} B,"
                        f" container {len(data)} B")
    side = np.frombuffer(data, np.float16, 2 * b * c, off)
    mins, maxs = side[:b * c].reshape(b, c), side[b * c:].reshape(b, c)
    stream = unpack(data[off + silen:], bits, count).reshape(want)
    return from_stream(stream, shape), mins, maxs
