"""Bytes of the port's codec kernels, which more than one family drives:
the yardstick of their rooflines, independent of the program's own cost
counter. A kernel's bytes count each input byte read once and each output
byte written once. A family's products (``request_flops``) are its own.
"""
from __future__ import annotations


def quantize_bytes(b: int, r: int, c: int, bits: int) -> int:
    """The C selected float32 channels of (B, R, P) read, the (C,) int32
    selection read, the codes and the (B, C) fp16 mins and maxs written."""
    code = 1 if bits <= 8 else 2
    return b * r * c * 4 + c * 4 + b * r * c * code + 2 * b * c * 2


def consolidate_bytes(b: int, r: int, c: int, bits: int) -> int:
    """The C selected float32 channels of z~ (B, R, P) read and written in
    place, the codes, the fp16 side info and the (C,) selection read."""
    code = 1 if bits <= 8 else 2
    return 2 * b * r * c * 4 + b * r * c * code + 2 * b * c * 2 + c * 4
