"""The CNN-BaF family: BaF split inference on the YOLOv3 stem.

A camera runs the CNN to the split, quantizes C of the P split channels
(eq. 4) and sends them; the cloud restores all P with the BaF predictor,
consolidates them (eq. 6) and finishes the network. The port's program is
its ``CNN``, ``BaFConv``, ``CompressionPlan`` and, in the gateway cells,
``ServingGateway``; the plain reference is ``portbench/reference``.

What the harness calls (``portbench/README.md``, "a model family"):
``KINDS``, ``PRODUCT_PEAK``, :func:`make_inputs`, :func:`build`,
:func:`clients`, :func:`window`, :func:`reference`, :func:`numbers`,
:func:`smoke`, :func:`request_flops` and :func:`check_config`. The rest
are this family's own parts.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import counts, inputs, loops
from portbench.reference import model as ref
from portbench.reference import wire

# cloud_closed_loop: pool blobs through decode, restore and the cloud tail;
# edge_closed_loop: frames through the edge CNN and encode to wire bytes;
# gateway_serve: frames through ServingGateway.serve, edge and cloud
KINDS = ("cloud_closed_loop", "edge_closed_loop", "gateway_serve")
# the peaks.json rate that baf_mfu divides a request's products by
PRODUCT_PEAK = "float32_product_flops_per_s"
BLOCK = 8                   # frames a reference call


# ---------------------------------------------------------------- inputs

def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, draw, scale) of every weight of the CNN and the BaF net.

    draw ``n``: scale * N(0, 1); ``u``: uniform in [scale, 3 * scale)
    (BN scale and variance in [0.5, 1.5), PReLU slopes in [0.1, 0.3)).
    """
    specs = []

    def conv_bn(prefix, cin, cout, k):
        specs.append((f"{prefix}.conv.weight", (cout, cin, k, k), "n",
                      math.sqrt(2.0 / (cin * k * k))))
        specs.append((f"{prefix}.bn.scale", (cout,), "u", 0.5))
        specs.append((f"{prefix}.bn.bias", (cout,), "n", 0.1))
        specs.append((f"{prefix}.bn.mean", (cout,), "n", 0.1))
        specs.append((f"{prefix}.bn.var", (cout,), "u", 0.5))

    for i, (cin, cout, k, _) in enumerate(cfg["stem"]):
        conv_bn(f"cnn.stem.{i}", cin, cout, k)
    cin, cout, k, _ = cfg["split"]
    conv_bn("cnn.split", cin, cout, k)
    for j in range(cfg["tail_res_blocks"]):
        for i, (cin, cout, k) in enumerate(cfg["tail"]):
            conv_bn(f"cnn.tail.{2 * j + i}", cin, cout, k)
    p, classes = cfg["split_shape"][2], cfg["num_classes"]
    specs.append(("cnn.head.weight", (p, classes), "n", math.sqrt(1.0 / p)))
    specs.append(("cnn.head.bias", (classes,), "n", 0.1))
    c, hid, q = cfg["c"], cfg["baf_hidden"], cfg["split_q"]
    for name, cin, cout in (("up", c, hid), ("c2", hid, hid),
                            ("c3", hid, hid), ("c4", hid, q)):
        specs.append((f"baf.{name}.weight", (cout, cin, 3, 3), "n",
                      math.sqrt(2.0 / (cin * 9))))
        specs.append((f"baf.{name}.bias", (cout,), "n", 0.05))
        if name != "c4":
            specs.append((f"baf.{name}_act.alpha", (cout,), "u", 0.1))
    return specs


def make_frames(cfg: dict, n: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """(n, S, S, 3) float32 frames, uniform in [0, 1), in one call."""
    s = cfg["input_size"]
    return torch.rand((n, s, s, 3), generator=gen, device=device)


def make_selection(cfg: dict, seed: int) -> np.ndarray:
    """C distinct channels of the P split channels, in a seeded order."""
    rng = np.random.default_rng([seed & inputs.SEED_MASK, 1])
    return rng.permutation(cfg["split_shape"][2])[:cfg["c"]].astype(np.int64)


@dataclass
class Inputs:
    weights: dict                # the benchmark's own, read by both sides
    frames: object               # (pool, S, S, 3) on the device, until clients
    frames_host: np.ndarray      # the same frames on the host
    sel: np.ndarray              # the C selected split channels
    schedule: inputs.Schedule
    pool_blobs: list | None = None   # the cloud cells' clients' requests


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """The weights, then the frames, from one generator on ``device``; the
    channel selection and the schedule from the seed on the host."""
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    gen = inputs.generator(seed, device)
    weights = inputs.make_weights(weight_specs(cfg), gen, device)
    frames = make_frames(cfg, traffic["pool"], gen, device)
    return Inputs(weights, frames, frames.cpu().numpy(),
                  make_selection(cfg, seed),
                  inputs.Schedule(seed, traffic["pool"],
                                  traffic.get("sample_share", 1.0)))


# --------------------------------------------------------------- program

@dataclass
class Program:
    cnn: object
    baf: object
    plan: object
    edge: object                 # img (B, S, S, 3) -> z (B, H, W, P)
    cloud: object                # z~ (B, H, W, P) -> logits
    gateway: object = None


def build(cfg: dict, traffic: dict, inp: Inputs,
          device: torch.device) -> Program:
    """The port's objects for one cell, on ``device``, loaded with the
    benchmark's weights."""
    from repro_torch import pipeline
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.core.split import cnn_fns
    from repro_torch.models.cnn import CNN, CNNConfig

    cnn = CNN(CNNConfig(width_mult=cfg["width_mult"],
                        input_size=cfg["input_size"],
                        num_classes=cfg["num_classes"],
                        tail_res_blocks=cfg["tail_res_blocks"]),
              device=device)
    baf = BaFConv(BaFConvConfig(c=cfg["c"], q=cfg["split_q"],
                                hidden=cfg["baf_hidden"]), device=device)
    inputs.load(cnn, inp.weights, "cnn.")
    inputs.load(baf, inp.weights, "baf.")
    op = pipeline.OperatingPoint(c=cfg["c"], bits=cfg["bits"],
                                 backend=traffic["backend"],
                                 tiling=cfg["tiling"])
    spec = pipeline.ModelSpec(sel_idx=inp.sel, params=cnn, baf_params=baf)
    plan = pipeline.compile(op, spec, device=device)
    edge, cloud = cnn_fns(cnn)
    gateway = None
    if traffic["kind"] == "gateway_serve":
        from repro_torch.serve.gateway import ServingGateway
        gateway = ServingGateway(cnn, {cfg["c"]: (baf, inp.sel)},
                                 channel=None, default_op=op,
                                 max_batch=traffic["batch"], device=device)
    return Program(cnn, baf, plan, edge, cloud, gateway)


def to_device(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """One (1, S, S, 3) host frame on the device, as the gateway moves a
    request's image."""
    from repro_torch.core.split import to_device as port_to_device
    return port_to_device(frame, device)


def clients(kind: str, prog: Program, traffic: dict, inp: Inputs,
            device: torch.device) -> None:
    """The cloud cells' clients: every pool frame through the port's edge
    to a blob, in ``inp.pool_blobs``. The device's frames are dropped."""
    if kind == "cloud_closed_loop":
        inp.pool_blobs = [prog.plan.encode(prog.edge(inp.frames[i:i + 1]))
                          for i in range(inp.frames.shape[0])]
    inp.frames = None


# --------------------------------------------------------------- windows

def cloud_closed_loop(prog, traffic, pool_blobs, schedule, seconds, span):
    """decode_batch -> restore (consolidate kernel) -> cloud -> logits on
    the host, a micro-batch at a time, as ``ServingGateway._run_batch``."""
    plan, batch = prog.plan, traffic["batch"]

    def serve(frames):
        with span("decode_batch"):
            decoded = plan.decode_batch([pool_blobs[f] for f in frames])
        with span("restore"):
            z = plan.restore(decoded.pad_to(batch))
        with span("cloud"):
            out = prog.cloud(z)
        with span("to_host"):
            logits = out.cpu().numpy()
        return (time.perf_counter(), logits[:len(frames)],
                [pool_blobs[f].nbytes for f in frames])

    return loops.closed_loop(traffic["outstanding"], batch, seconds, serve,
                             lambda i: int(schedule.frame[i]))


def edge_closed_loop(prog, traffic, frames_host, schedule, seconds, span,
                     device):
    """Each frame: to the device, edge CNN at B=1, ``plan.encode`` (the
    quantize kernel, one copy, packing) to wire bytes on the host, as
    ``ServingGateway.encode_request``. The blobs of ``schedule.keep``'s
    requests are kept for the check."""
    plan = prog.plan
    index = [0]

    def serve(frames):
        (f,) = frames
        i = index[0]
        index[0] += 1
        with span("to_device"):
            x = to_device(frames_host[f:f + 1], device)
        with span("edge"):
            z = prog.edge(x)
        with span("encode"):
            blob = plan.encode(z)
        keep = blob.data if schedule.keep[i] else None
        return time.perf_counter(), [keep], [blob.nbytes]

    return loops.closed_loop(traffic["clients"], 1, seconds, serve,
                             lambda i: int(schedule.frame[i]))


def gateway_serve(prog, traffic, frames_host, seconds, span):
    """``ServingGateway.serve`` on ``frames_per_call`` frames at a time, the
    pool's groups in turn, until ``seconds`` have passed (at least one
    call); all of a call's requests are enqueued when it starts and
    answered when it returns."""
    per = traffic["frames_per_call"]
    groups = frames_host.shape[0] // per
    win = loops.Window()
    win.t0 = time.perf_counter()
    deadline = win.t0 + seconds
    call = 0
    while True:
        g = call % groups
        t_enq = time.perf_counter()
        with span("serve"):
            responses, _ = prog.gateway.serve(frames_host[g * per:
                                                          (g + 1) * per])
        t = time.perf_counter()
        win.batches.append((t, per))
        for j, r in enumerate(responses):
            win.latencies.append(t - t_enq)
            win.wire_bytes += r.stats.wire_bits // 8
            win.frames.append(g * per + j)
            win.answers.append(np.asarray(r.logits))
        win.attempted += per
        call += 1
        if t >= deadline:
            break
    win.t1 = t
    return win


def window(kind: str, prog: Program, traffic: dict, inp: Inputs,
           seconds: float, span, device: torch.device) -> loops.Window:
    """The measured window of ``kind`` (one of ``KINDS``)."""
    if kind == "cloud_closed_loop":
        return cloud_closed_loop(prog, traffic, inp.pool_blobs,
                                 inp.schedule, seconds, span)
    if kind == "edge_closed_loop":
        return edge_closed_loop(prog, traffic, inp.frames_host,
                                inp.schedule, seconds, span, device)
    if kind == "gateway_serve":
        return gateway_serve(prog, traffic, inp.frames_host, seconds, span)
    raise ValueError(f"cnn_baf runs no traffic kind {kind!r}")


# ------------------------------------------------- reference and numbers
#
# The reference works every frame of the pool out again from the
# benchmark's own frames and weights: the edge, eq. 4 and its fp16 side
# info, the container, its unpacking, the restore and the cloud. The
# program's answers are read only to be judged:
#
# * ``logit_gap`` (cloud and gateway cells): over every answered request,
#   the largest ``|logit - reference logit|`` over the request's largest
#   ``|reference logit|``.
# * ``code_bin_excess`` (edge cell): over the sampled requests' wire
#   bytes, parsed by the reference, how far (in bins of the container's
#   own fp16 side info) the reference's split tensor lies outside the bin
#   of the code sent for it, at the worst code; a container the reference
#   cannot read counts as infinite.
#
# ``tf32=True`` computes the reference in TF32, the control that each
# limit must fail.

def _blocks(frames_host: np.ndarray, device):
    for i in range(0, frames_host.shape[0], BLOCK):
        yield torch.from_numpy(frames_host[i:i + BLOCK]).to(device)


def split_tensors(cfg, w, sel, frames_host, device, *, tf32=False):
    """(pool, H, W, C) of the selected split channels of every frame."""
    idx = torch.as_tensor(sel, device=device)
    return torch.cat([ref.edge(w, cfg, img, tf32=tf32)[..., idx]
                      for img in _blocks(frames_host, device)])


def blobs(cfg, w, sel, frames_host, device, *, tf32=False) -> list[bytes]:
    """The container of every frame, one frame a request, as a client of
    the reference would send it."""
    out = []
    z = split_tensors(cfg, w, sel, frames_host, device, tf32=tf32)
    for i in range(z.shape[0]):
        zi = z[i:i + 1]
        mins, maxs = ref.side_info(zi)
        codes = ref.quantize(zi, mins, maxs, cfg["bits"])
        out.append(wire.write(codes.cpu().numpy(), mins, maxs, cfg["bits"]))
    return out


def logits(cfg, w, sel, frames_host, device, *, tf32=False) -> np.ndarray:
    """(pool, classes): each frame through the whole reference pipeline."""
    shape = (1, *cfg["split_shape"][:2], cfg["c"])
    idx = torch.as_tensor(sel, device=device)
    rows = []
    data = blobs(cfg, w, sel, frames_host, device, tf32=tf32)
    for i in range(0, len(data), BLOCK):
        parts = [wire.read(b, shape, cfg["bits"]) for b in data[i:i + BLOCK]]
        codes = torch.from_numpy(np.concatenate([p[0] for p in parts]))
        mins = np.concatenate([p[1] for p in parts])
        maxs = np.concatenate([p[2] for p in parts])
        z = ref.restore(w, cfg, idx, codes.to(device), mins, maxs, tf32=tf32)
        rows.append(ref.cloud(w, cfg, z, tf32=tf32).cpu().numpy())
    return np.concatenate(rows)


def logit_gap(frames: list, answers: list, ref_logits: np.ndarray) -> float:
    if not answers:
        return math.inf
    got = np.stack([np.asarray(a, np.float64) for a in answers])
    want = ref_logits[np.asarray(frames)].astype(np.float64)
    gap = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    return float(np.nan_to_num(gap, nan=math.inf).max())


def bin_excess(z_sel: torch.Tensor, codes: torch.Tensor, mins, maxs,
               bits: int) -> float:
    """Largest distance, in bins, of z_sel (1, H, W, C) outside the bins of
    ``codes`` under the fp16 side info (mins, maxs) (1, C)."""
    levels = float((1 << bits) - 1)
    dev = z_sel.device
    m = torch.from_numpy(mins.astype(np.float32)).to(dev)[:, None, None, :]
    mx = torch.from_numpy(maxs.astype(np.float32)).to(dev)[:, None, None, :]
    s = torch.clamp((z_sel - m) / torch.clamp(mx - m, min=1e-12) * levels,
                    0, levels)
    excess = torch.clamp((s - codes.to(dev).float()).abs() - 0.5, min=0)
    return float(torch.nan_to_num(excess, nan=math.inf).max())


def code_bin_excess(cfg, frames: list, answers: list,
                    z_sel: torch.Tensor) -> float:
    if not answers:
        return math.inf
    shape = (1, *cfg["split_shape"][:2], cfg["c"])
    worst = 0.0
    for f, data in zip(frames, answers):
        try:
            codes, mins, maxs = wire.read(data, shape, cfg["bits"])
        except (wire.WireError, ValueError):
            return math.inf
        worst = max(worst, bin_excess(z_sel[f:f + 1], torch.from_numpy(codes),
                                      mins, maxs, cfg["bits"]))
    return worst


def reference(kind: str, cfg: dict, inp: Inputs, device, tf32=False):
    """The reference's result that :func:`numbers` compares with: the
    split tensors (edge) or every frame's logits."""
    args = (cfg, inp.weights, inp.sel, inp.frames_host, device)
    if kind == "edge_closed_loop":
        return split_tensors(*args, tf32=tf32)
    return logits(*args, tf32=tf32)


def numbers(kind: str, cfg: dict, inp: Inputs, device, frames, answers,
            want, *, control: bool = False) -> dict:
    """{name: reading} of one run's answers against ``want``, the float32
    reference's result. ``control``: the answers are replaced by the TF32
    reference's own (the control run)."""
    if kind == "edge_closed_loop":
        if control:
            data = blobs(cfg, inp.weights, inp.sel, inp.frames_host, device,
                         tf32=True)
            frames, answers = list(range(len(data))), data
        return {"code_bin_excess": code_bin_excess(cfg, frames, answers,
                                                   want)}
    if control:
        got = reference(kind, cfg, inp, device, tf32=True)
        frames, answers = list(range(len(got))), list(got)
    return {"logit_gap": logit_gap(frames, answers, want)}


# ---------------------------------------------------------------- counts
#
# Products are multiply-adds counted twice, only those the result needs: a
# stride-2 transposed conv counts each input pixel against its 3x3 taps,
# not the zeros a dilated input would insert.

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


def all_counts(cfg: dict) -> dict:
    """The ``counts`` block a configuration file carries."""
    r = cfg["split_shape"][0] * cfg["split_shape"][1]
    c, bits = cfg["c"], cfg["bits"]
    return {"edge_flops": edge_flops(cfg),
            "restore_flops": restore_flops(cfg),
            "cloud_flops": cloud_flops(cfg),
            "quantize_bytes_b1": counts.quantize_bytes(1, r, c, bits),
            "consolidate_bytes_b8": counts.consolidate_bytes(8, r, c, bits),
            "consolidate_bytes_b32": counts.consolidate_bytes(32, r, c,
                                                              bits)}


# the configuration's counts that one request of each kind needs
REQUEST_COUNTS = {"cloud_closed_loop": ("restore_flops", "cloud_flops"),
                  "edge_closed_loop": ("edge_flops",),
                  "gateway_serve": ("edge_flops", "restore_flops",
                                    "cloud_flops")}


def request_flops(cfg: dict, kind: str) -> int:
    """Products of every convolution and of the dense head that one
    request of ``kind`` needs, from the configuration's ``counts``."""
    return sum(cfg["counts"][k] for k in REQUEST_COUNTS[kind])


# ----------------------------------------------------------------- smoke

def smoke_config(cfg: dict, size: int = 256) -> dict:
    """The same layer tables at a quarter of the widths and ``size``-pixel
    frames. On smaller frames the split tensor is so small that a code
    flipped by float32 rounding at a bin edge moves the pooled logits near
    the cells' limits (1.02e-4 at 128x128 against 1.64e-5 at 256x256, over
    13 seeds)."""
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
    s["counts"] = all_counts(s)
    return s


def smoke_traffic(traffic: dict) -> dict:
    """A pool of 8 and a few clients."""
    t = dict(traffic, pool=8)
    if t["kind"] == "cloud_closed_loop":
        t.update(outstanding=4, batch=2)
    elif t["kind"] == "edge_closed_loop":
        t.update(clients=3, sample_share=0.5)
    else:
        t.update(frames_per_call=4, batch=2)
    return t


def smoke(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at its CPU smoke size: a whole run (set-up, window,
    reference) in about a second."""
    return smoke_config(cfg), smoke_traffic(traffic)


# ----------------------------------------------------------------- check

def check_config(cfg: dict) -> None:
    """Raise ValueError where a configuration departs from what this
    family's cells assume: the paper's split (64x64x256, Q=128), a
    ``counts`` block as :func:`all_counts` gives it, and weights that fit
    the port's modules key for key and shape for shape."""
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN, CNNConfig

    name = cfg.get("name")
    if (cfg["split_shape"], cfg["split_q"]) != ([64, 64, 256], 128):
        raise ValueError(f"{name}: split_shape {cfg['split_shape']}, "
                         f"split_q {cfg['split_q']}; the paper's are "
                         f"[64, 64, 256], 128")
    if cfg["counts"] != all_counts(cfg):
        raise ValueError(f"{name}: counts {cfg['counts']} are not "
                         f"{all_counts(cfg)}")
    cnn = CNN(CNNConfig(cfg["width_mult"], cfg["input_size"],
                        cfg["num_classes"], cfg["tail_res_blocks"]),
              device="meta")
    baf = BaFConv(BaFConvConfig(cfg["c"], cfg["split_q"], cfg["baf_hidden"]),
                  device="meta")
    want = {f"cnn.{k}": tuple(v.shape) for k, v in cnn.state_dict().items()}
    want.update({f"baf.{k}": tuple(v.shape)
                 for k, v in baf.state_dict().items()})
    got = {k: s for k, s, _, _ in weight_specs(cfg)}
    if got != want:
        odd = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise ValueError(f"{name}: weights {odd} do not fit the port's "
                         f"modules")
