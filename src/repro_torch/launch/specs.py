"""Abstract inputs and the step of every (arch x shape x mesh) cell.

Counterpart of ``repro/launch/specs.py``. Where the reference builds
``ShapeDtypeStruct``s and ``NamedSharding``s for ``jax.jit``, a cell here
is built from ``meta`` tensors (no parameter or activation is allocated,
so arctic-480b's cell is built on a laptop) and DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (("data", "model") for one pod, ("pod", "data", "model") for two).
The dry run (``launch.dryrun``) places the meta arguments as DTensors over
a fake process group and runs the step once; ``chip_smoke.py`` places real
weights on the card by the same placements and holds each cell against the
step built without one.

A cell's ``fn`` runs the engine's or the trainer's step under the
reference's axis rules (``distributed.api.axis_ctx``) and
``implicit_replication`` (the tensors a step makes itself, positions and
masks, are replicated), on a skeleton of the model (``device="meta"``)
whose weights ``torch.func.functional_call`` swaps in. The arguments are
congruent with ``args``: parameters are a ``{name: tensor}`` dict of the
port's names (``layers.3.attn.wq``), a train state is a ``TrainState``, a
cache is the engine's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._redistribute import \
    use_min_cost_redistribution_plan
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.distributed import api as dist_api
from repro_torch.distributed.sharding import (KV_NAMES, _map_tensors,
                                              axis_sizes, batch_pspec,
                                              cache_pspecs, params_pspecs,
                                              to_placements)
from repro_torch.models.encdec import init_encdec, init_encdec_cache
from repro_torch.models.lm import init_decode_cache, init_lm
from repro_torch.optim.adamw import AdamWState
from repro_torch.serve.engine import (init_long_state, make_decode_step,
                                      make_long_ingest, make_prefill_step)
from repro_torch.train.trainer import (TrainConfig, TrainState, init_params,
                                       init_train_state, make_train_step)

LONG_BLOCK = 8192

# per-arch microbatch counts for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "qwen2_72b": 16, "arctic_480b": 16, "starcoder2_15b": 8,
    "nemotron4_15b": 8, "pixtral_12b": 8, "qwen2_7b": 4,
    "olmoe_1b_7b": 2, "rwkv6_3b": 2, "zamba2_1p2b": 8, "whisper_tiny": 1,
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_batch_specs(cfg: ArchConfig, shape_name: str, *, arch: str = "",
                     shape: Optional[dict] = None) -> dict:
    """The abstract input batch of a shape cell (``shape``: the cell's
    entry of SHAPES, or a cut of it), as meta tensors."""
    sh = shape or SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    if cfg.family == "audio":
        if kind in ("train", "prefill"):
            return {"audio_embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": _meta((b, s), torch.int32),
                    "labels": _meta((b, s), torch.int32)}
        return {"token": _meta((b,), torch.int32)}
    if not cfg.embed_inputs:   # pixtral: precomputed patch/text embeddings
        if kind in ("train", "prefill"):
            return {"embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                    "labels": _meta((b, s), torch.int32)}
        return {"token": _meta((b,), torch.int32)}
    if kind in ("train", "prefill"):
        return {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}
    if kind == "long":
        return {"tokens": _meta((b, s), torch.int32)}
    return {"token": _meta((b,), torch.int32)}


def batch_specs_of(specs: dict, mesh, *, multi_pod: bool) -> dict:
    """{name: spec}: the batch dim over (pod,) data where it divides."""
    return {k: (batch_pspec(v.shape[0], mesh, multi_pod=multi_pod),)
            + (None,) * (v.dim() - 1) for k, v in specs.items()}


def batch_shardings(specs: dict, mesh, *, multi_pod: bool) -> dict:
    """{name: placements} of a batch."""
    return {k: to_placements(s, mesh) for k, s in
            batch_specs_of(specs, mesh, multi_pod=multi_pod).items()}


def abstract_params(cfg: ArchConfig, init_fn) -> dict:
    """{name: meta tensor}: the weights ``init_fn`` would draw."""
    return {k: p.detach() for k, p in
            init_fn(cfg, device="meta").named_parameters()}


@dataclass
class CellProgram:
    """Everything needed to run one (arch x shape x mesh) cell. ``args``
    are meta tensors; ``in_specs``/``out_specs`` hold a spec (a tuple of
    mesh-axis names) for each tensor leaf of the arguments and outputs,
    ``in_placements`` and ``out_placements(out)`` the same as DTensor
    placements."""
    fn: Callable
    args: tuple
    in_specs: tuple
    out_specs: Any
    in_placements: tuple
    kind: str
    cfg: ArchConfig
    mesh: Any
    donate: tuple = ()
    tcfg: Optional[TrainConfig] = None

    def out_placements(self, out):
        """The placements of the outputs ``out`` of ``fn``."""
        return placements_of(self.out_specs, self.mesh, out)


def _vocab_axis(cfg: ArchConfig, mesh, rules):
    """Model-axis factor for the logits vocab dim; None when indivisible
    (whisper's 51865 stays replicated at the boundary)."""
    ax = rules.rules.get("vocab")
    if ax is None:
        return None
    sizes = axis_sizes(mesh)
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= sizes[a]
    return ax if cfg.vocab % size == 0 else None


def _walk(fn, tree, other):
    """``tree`` with each tensor leaf t replaced by fn(t, the leaf of
    ``other`` at the same place); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, other)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(fn, v, o) for v, o in zip(tree, other)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, o) for v, o in zip(tree, other))
    if isinstance(tree, dict):
        return {k: _walk(fn, v, other[k]) for k, v in tree.items()}
    return tree


def placements_of(specs, mesh, like):
    """The placements of every tensor leaf of ``like`` by its spec."""
    return _walk(lambda _, s: to_placements(s, mesh), like, specs)


def place(args, placements, mesh):
    """``args`` as DTensors on ``mesh`` by ``placements`` (congruent).
    Every rank passes the same values; each keeps its shard of its own
    copy, with no collective (gloo's scatter reads a CUDA tensor's pointer
    as host memory)."""
    return _walk(lambda t, p: distribute_tensor(t, mesh, p,
                                                src_data_rank=None),
                 args, placements)


class _Bound(nn.Module):
    """A step of the model's skeleton, so that ``functional_call`` can
    swap the weights in."""

    def __init__(self, model: nn.Module, step):
        super().__init__()
        self.model = model
        self.step = step

    def forward(self, *args):
        return self.step(self.model, *args)


@contextlib.contextmanager
def _cell_ctx(rules):
    """The axis rules; plain tensors the step makes replicated; DTensor's
    greedy redistribution planner (the graph search it otherwise runs to
    cost each op's strategies grows with the mesh's axes and dominates a
    cell on a 3-axis mesh); products summed at once
    (``distributed.api.WholeProducts``), in the backward's remat
    recompute too, which the autograd engine then runs on this thread,
    where the mode is active."""
    with dist_api.axis_ctx(rules), implicit_replication(), \
            use_min_cost_redistribution_plan(False), \
            dist_api.WholeProducts(), \
            torch.autograd.set_multithreading_enabled(False):
        yield


def build_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool,
               smoke: bool = False,
               tcfg_overrides: Optional[dict] = None,
               overrides: Optional[dict] = None,
               cut: Optional[tuple] = None) -> CellProgram:
    """``overrides``, the reference's levers:
      seq_parallel:       bool (default True)  act_hidden sharding on/off
      decode_seq_shard:   bool (default True)  KV-cache seq-dim fallback
      remat_policy:       'full' | 'dots' | 'dots_no_batch'
      microbatches:       int
      flash_decode:       bool  sequence-sharded decode over "model"
      bf16_norm_grad:     bool  the low-memory RMSNorm backward
      serve_bf16_params:  bool (default True)  serve bf16 weights
    ``cut``: a ``(config, shape)`` pair used in place of the lookup of
    ``arch`` and ``SHAPES[shape_name]`` (a cell cut in depth or batch)."""
    ov = overrides or {}
    if cut is not None:
        cfg, sh = cut
    else:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        sh = SHAPES[shape_name]
    if ov.get("bf16_norm_grad"):
        cfg = cfg.with_(norm_grad="bf16")
    kind = sh["kind"]
    if shape_name not in cfg.supported_shapes:
        raise ValueError(f"{arch} does not support {shape_name} "
                         f"(full attention is quadratic)")
    init_fn = init_encdec if cfg.family == "audio" else init_lm
    a_params = abstract_params(cfg, init_fn)
    # ZeRO across pods too, but for the compressed cross-pod exchange:
    # pod-replicated, tensor-parallel weights with replicated embeddings
    compress = bool((tcfg_overrides or {}).get("grad_compress_bits"))
    fsdp_axis = ("pod", "data") if (multi_pod and not compress) else "data"
    if compress:
        fsdp_axis = None
    p_specs = params_pspecs(a_params, mesh, data_axis=fsdp_axis)
    if compress:
        p_specs = {k: (tuple([None] * a_params[k].dim())
                       if any(n in ("embed", "lm_head")
                              for n in k.split(".")) else s)
                   for k, s in p_specs.items()}
    batch = make_batch_specs(cfg, shape_name, shape=sh)
    b_specs = batch_specs_of(batch, mesh, multi_pod=multi_pod)
    seq_par = ov.get("seq_parallel", True)
    rules = (dist_api.train_rules(multi_pod, seq_parallel=seq_par)
             if kind == "train"
             else dist_api.serve_rules(
                 multi_pod, weight_mode=cfg.serve_weight_sharding,
                 seq_parallel=seq_par))
    bp = batch_pspec(sh["global_batch"], mesh, multi_pod=multi_pod)

    def cell(fn, args, in_specs, out_specs, donate=()):
        return CellProgram(
            fn=fn, args=args, in_specs=in_specs, out_specs=out_specs,
            in_placements=placements_of(in_specs, mesh, args), kind=kind,
            cfg=cfg, mesh=mesh, donate=donate)

    if kind == "train":
        kw = dict(num_microbatches=ov.get(
            "microbatches", TRAIN_MICROBATCHES.get(arch, 4)))
        if "remat_policy" in ov:
            kw["remat_policy"] = ov["remat_policy"]
        kw.update(tcfg_overrides or {})
        tcfg = TrainConfig(**kw)
        a_state = init_train_state(
            {k: _meta(v.shape, torch.float32) for k, v in a_params.items()},
            tcfg)
        a_state = a_state._replace(step=_meta((), torch.int32))
        state_specs = TrainState(
            params=p_specs, opt=AdamWState(count=(), mu=p_specs,
                                           nu=p_specs),
            step=(), ef=(p_specs if a_state.ef is not None else None))
        steps = []      # built at the first call: the compressed step
                        # reads the mesh's process groups

        def fn(state, batch):
            if not steps:
                steps.append(make_train_step(cfg, tcfg, mesh=mesh,
                                             multi_pod=multi_pod))
            with _cell_ctx(rules):
                return steps[0](state, batch)
        out_specs = (state_specs, {"loss": (), "grad_norm": (), "lr": ()})
        prog = cell(fn, (a_state, batch), (state_specs, b_specs), out_specs,
                    donate=(0,))
        prog.tcfg = tcfg
        return prog

    # serving: bf16 resident weights, fsdp axis as the config says
    if ov.get("serve_bf16_params", True):
        cfg = cfg.with_(param_dtype=cfg.dtype)
        a_params = abstract_params(cfg, init_fn)
    data_axis = "data" if cfg.serve_weight_sharding == "2d" else None
    p_specs = params_pspecs(a_params, mesh, data_axis=data_axis)
    skeleton = init_fn(cfg, device="meta")

    def bound(step):
        mod = _Bound(skeleton, step)

        def call(params, *args):
            weights = {"model." + k: v for k, v in params.items()}
            return torch.func.functional_call(mod, weights, args)
        return call

    if kind == "prefill":
        pre = bound(make_prefill_step(cfg))

        def fn(params, batch):
            with _cell_ctx(rules):
                return pre(params, batch)
        out = (bp, None, _vocab_axis(cfg, mesh, rules))
        return cell(fn, (a_params, batch), (p_specs, b_specs), out)

    if kind == "decode":
        dec = bound(make_decode_step(cfg))
        b = sh["global_batch"]
        flash = bool(ov.get("flash_decode", False))
        if cfg.family == "audio":
            enc = _meta((b, cfg.encdec.enc_len_decode, cfg.d_model),
                        cfg.dtype)
            a_cache = init_encdec_cache(skeleton, enc, sh["seq_len"])
        else:
            a_cache = init_decode_cache(cfg, b, sh["seq_len"], device="meta")
        c_specs = cache_pspecs(a_cache, mesh, bp,
                               seq_fallback=ov.get("decode_seq_shard", True))
        if flash:
            # the flash-decode reads each rank's slots of the sequence: the
            # KV caches' sequence over "model" (the reference's shard_map
            # takes them so)
            msize = axis_sizes(mesh)["model"]

            def seq_over_model(names, t, specs=c_specs):
                spec = _spec_at(specs, names)
                if t.dim() == 4 and t.shape[1] % msize == 0 and any(
                        n in KV_NAMES for n in names):
                    return (spec[0], "model", None, None)
                return spec
            c_specs = _map_tensors(seq_over_model, a_cache)

        def fn(params, cache, token):
            with _cell_ctx(rules):
                if flash:
                    with dist_api.flash_decode_ctx(mesh, batch_spec=bp):
                        return dec(params, cache, token)
                return dec(params, cache, token)
        out = ((bp, _vocab_axis(cfg, mesh, rules)), c_specs)
        return cell(fn, (a_params, a_cache, _meta((b,), torch.int32)),
                    (p_specs, c_specs, (bp,)), out, donate=(1,))

    # long-context ingestion (ssm / hybrid only)
    block = min(LONG_BLOCK, sh["seq_len"])
    if cfg.family == "hybrid":
        block = cfg.hybrid.attn_window_long
    ingest = bound(make_long_ingest(cfg, block=block))

    def fn(params, tokens):
        with _cell_ctx(rules):
            return ingest(params, tokens)
    a_state = init_long_state(cfg, sh["global_batch"], block, device="meta")
    ls_specs = cache_pspecs(a_state, mesh, bp)
    out = ((bp, _vocab_axis(cfg, mesh, rules)), ls_specs)
    return cell(fn, (a_params, batch["tokens"]), (p_specs, (bp, None)), out)


def _spec_at(tree, names):
    """The entry of a spec tree at a ``_map_tensors`` path."""
    for n in names:
        tree = tree[int(n)] if n.isdigit() else (
            getattr(tree, n) if hasattr(tree, "_fields") else tree[n])
    return tree


def local_bytes(tree) -> int:
    """Bytes of this process's shards of every tensor leaf of ``tree``."""
    total = 0

    def add(t, _):
        nonlocal total
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
        return t
    _walk(add, tree, tree)
    return total


def real_args(cell: CellProgram, *, seed: int = 0, device=None) -> tuple:
    """Arguments congruent with ``cell.args`` with values on ``device``:
    the weights the port draws from ``seed`` (float32 masters for a train
    cell), tokens and embeddings drawn from ``seed`` with numpy, empty
    caches (an encoder output drawn for whisper's). The same on every
    rank."""
    cfg, args = cell.cfg, cell.args
    rng = np.random.default_rng(seed)
    init_fn = init_encdec if cfg.family == "audio" else init_lm

    def batch_like(spec: dict) -> dict:
        out = {}
        for k, v in spec.items():
            if v.dtype == torch.int32:
                a = rng.integers(0, cfg.vocab, size=tuple(v.shape))
            else:
                a = rng.normal(size=tuple(v.shape))
            out[k] = torch.from_numpy(a).to(v.dtype).to(device)
        return out

    if cell.kind == "train":
        return (init_train_state(init_params(cfg, seed=seed, device=device),
                                 cell.tcfg), batch_like(args[1]))
    model = init_fn(cfg, seed=seed, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    if cell.kind == "prefill":
        return params, batch_like(args[1])
    if cell.kind == "long":
        return params, batch_like({"tokens": args[1]})["tokens"]
    b = args[2].shape[0]
    max_len = _cache_len(args[1])
    if cfg.family == "audio":
        enc = batch_like({"e": _meta((b, cfg.encdec.enc_len_decode,
                                      cfg.d_model), cfg.dtype)})["e"]
        with torch.no_grad():
            cache = init_encdec_cache(model, enc, max_len)
    else:
        cache = init_decode_cache(cfg, b, max_len, device=device)
    return params, cache, batch_like({"t": args[2]})["t"]


def _cache_len(cache) -> int:
    """The slots of a decode cache's first KV cache (or 1: no KV cache)."""
    for name in ("kv", "shared_kv", "self_kv"):
        kvs = getattr(cache, name, None)
        if kvs:
            return kvs[0].k.shape[1]
    return 1
