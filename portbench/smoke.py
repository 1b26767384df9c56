"""Smoke-size cells for the CPU tests: the same layer tables at a quarter of
the widths, 256x256 frames, a pool of 8 and a few clients, so a whole run
(set-up, window, reference) takes about a second on the CPU. On smaller
frames the split tensor is so small that a code flipped by float32
rounding at a bin edge moves the pooled logits near the cells' limits
(1.02e-4 at 128x128 against 1.64e-5 at 256x256, over 13 seeds)."""
from __future__ import annotations

from portbench import bench, counts, spec


def smoke_config(cfg: dict, size: int = 256) -> dict:
    def ch(x):
        return x if x == 3 else max(4, round(x * 0.25))
    s = dict(cfg)
    s.update(input_size=size, width_mult=0.25,
             split_shape=[size // 8, size // 8, ch(cfg["split_shape"][2])],
             split_q=ch(cfg["split_q"]),
             stem=[[ch(a), ch(b), k, st] for a, b, k, st in cfg["stem"]],
             split=[ch(a) if i < 2 else a for i, a in enumerate(cfg["split"])],
             tail_res_blocks=1,
             tail=[[ch(a), ch(b), k] for a, b, k in cfg["tail"]],
             num_classes=8, c=16 if cfg["c"] == 64 else 12, baf_hidden=16)
    s["counts"] = counts.all_counts(s)
    return s


def smoke_traffic(traffic: dict) -> dict:
    t = dict(traffic, pool=8)
    if t["kind"] == "cloud_closed_loop":
        t.update(outstanding=4, batch=2)
    elif t["kind"] == "edge_closed_loop":
        t.update(clients=3, sample_share=0.5)
    else:
        t.update(frames_per_call=4, batch=2)
    return t


def smoke_cell(name: str) -> bench.Cell:
    """The cell ``name`` at smoke size, with its own limits."""
    c = spec.cell(name)
    return bench.Cell(name, cfg=smoke_config(spec.config(c["config"])),
                      traffic=smoke_traffic(spec.traffic(c["traffic"])),
                      limits=c["limits"])
