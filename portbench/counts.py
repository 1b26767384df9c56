"""Operations and bytes from a configuration's shapes: the yardstick of
``baf_mfu`` and the kernels' rooflines, independent of the program's own
cost counter.

Products are multiply-adds counted twice, only those the result needs: a
stride-2 transposed conv counts each input pixel against its 3x3 taps,
not the zeros a dilated input would insert. A kernel's bytes count each
input byte read once and each output byte written once.
"""
from __future__ import annotations


def _out(n: int, stride: int) -> int:
    return -(-n // stride)


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, k: int) -> int:
    return 2 * h_out * w_out * cin * cout * k * k


def edge_flops(cfg: dict) -> int:
    """The stem and the split conv for one frame."""
    n = cfg["input_size"]
    total = 0
    for cin, cout, k, s in cfg["stem"] + [cfg["split"]]:
        n = _out(n, s)
        total += conv_flops(n, n, cin, cout, k)
    return total


def restore_flops(cfg: dict) -> int:
    """The BaF backward net from C channels at the split's H x W to Q at
    2H x 2W, and the split conv back to P channels, for one request."""
    hw = cfg["split_shape"][0]
    c, hid, q = cfg["c"], cfg["baf_hidden"], cfg["split_q"]
    up = 2 * hw * hw * c * hid * 9              # each input pixel x 9 taps
    body = (conv_flops(2 * hw, 2 * hw, hid, hid, 3) * 2
            + conv_flops(2 * hw, 2 * hw, hid, q, 3))
    cin, cout, k, s = cfg["split"]
    return up + body + conv_flops(hw, hw, cin, cout, k)


def cloud_flops(cfg: dict) -> int:
    """The tail's residual pairs and the dense head, for one request."""
    hw = cfg["split_shape"][0]
    pair = sum(conv_flops(hw, hw, cin, cout, k) for cin, cout, k in cfg["tail"])
    return cfg["tail_res_blocks"] * pair + 2 * cfg["split_shape"][2] * \
        cfg["num_classes"]


def request_flops(cfg: dict, kind: str) -> int:
    """Products one request of a traffic kind needs."""
    cloud = restore_flops(cfg) + cloud_flops(cfg)
    return {"cloud_closed_loop": cloud,
            "edge_closed_loop": edge_flops(cfg),
            "gateway_serve": edge_flops(cfg) + cloud}[kind]


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


def all_counts(cfg: dict) -> dict:
    """The ``counts`` block a configuration file carries."""
    r = cfg["split_shape"][0] * cfg["split_shape"][1]
    c, bits = cfg["c"], cfg["bits"]
    return {"edge_flops": edge_flops(cfg),
            "restore_flops": restore_flops(cfg),
            "cloud_flops": cloud_flops(cfg),
            "quantize_bytes_b1": quantize_bytes(1, r, c, bits),
            "consolidate_bytes_b8": consolidate_bytes(8, r, c, bits),
            "consolidate_bytes_b32": consolidate_bytes(32, r, c, bits)}
