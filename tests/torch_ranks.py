"""Rank workers for the port's multi-process CPU tests (gloo).

``spawn(fn, world, shape, tmp, *args)`` starts ``world`` processes; each
joins a gloo group through a file under ``tmp`` (no TCP port, so parallel
test workers never collide), builds a (pod, data, model) DeviceMesh of
``shape``, runs ``fn(rank, mesh, *args)`` with one thread, and saves what
it returns; ``spawn`` returns the ranks' results in rank order. A rank
that raises fails the spawn. The workers import torch and the port only,
so a child starts without JAX.
"""
from __future__ import annotations

import os
import uuid

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import flash_decode_ctx, init_mesh


def _entry(rank, fn, world, shape, tmp, out, args):
    torch.set_num_threads(1)
    mesh = init_mesh(shape, backend="gloo", rank=rank, world=world,
                     init_file=os.path.join(tmp, "rendezvous"),
                     device_type="cpu")
    try:
        res = fn(rank, mesh, *args)
        torch.save(res, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, shape: tuple, tmp, *args) -> list:
    run = os.path.join(str(tmp), f"{fn.__name__}-{uuid.uuid4().hex}")
    os.makedirs(run)
    mp.spawn(_entry, args=(fn, world, tuple(shape), run, run, args),
             nprocs=world)
    return [torch.load(os.path.join(run, f"{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------

def psum_rank(rank, mesh, cases):
    """cases: [(bits, {name: (W, ...) float32 array})] -> per case this
    pod's (means, residuals) through ``quantized_pod_mean``."""
    from repro_torch.optim.grad_compress import quantized_pod_mean
    out = []
    for bits, leaves in cases:
        grads = {k: torch.from_numpy(v[rank]) for k, v in leaves.items()}
        out.append(quantized_pod_mean(grads, mesh, bits=bits))
    return out


def decode_rank(rank, mesh, cases):
    """cases: [(q, cache_k, cache_v, new_k, new_v, length)] with the whole
    caches -> per case (out, this rank's shard of k, of v) after
    ``seq_sharded_decode_attention`` over the model axis."""
    from repro_torch.distributed.collectives import \
        seq_sharded_decode_attention
    world = mesh.size(2)
    out = []
    for q, ck, cv, nk, nv, length in cases:
        s_loc = ck.shape[1] // world
        lk = torch.from_numpy(ck[:, rank * s_loc:(rank + 1) * s_loc]).clone()
        lv = torch.from_numpy(cv[:, rank * s_loc:(rank + 1) * s_loc]).clone()
        o, lk, lv = seq_sharded_decode_attention(
            torch.from_numpy(q), lk, lv, torch.from_numpy(nk),
            torch.from_numpy(nv), length, mesh, axis="model")
        out.append((o, lk, lv))
    return out


def lm_decode_rank(rank, mesh, arch, tokens, steps, max_len):
    """The arch's smoke LM (float32, seed 0) under ``flash_decode_ctx``
    over the model axis: the prompt fed token by token into a
    sequence-sharded cache, then ``steps`` greedy steps -> (the logits of
    every step, this rank's slots of each KV cache, the message with which
    a windowed cache is refused)."""
    from repro_torch import configs
    from repro_torch.models.attention import (Attention, attention_decode,
                                              init_kv_cache)
    from repro_torch.models.lm import init_decode_cache, init_lm, \
        lm_decode_step
    cfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
    model = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(tokens)
    logits = []
    with flash_decode_ctx(mesh, axis="model"), torch.no_grad():
        cache = init_decode_cache(cfg, toks.shape[0], max_len, device="cpu")
        for t in range(toks.shape[1]):
            lt, cache = lm_decode_step(model, cache, toks[:, t])
            logits.append(lt)
        for _ in range(steps):
            lt, cache = lm_decode_step(model, cache, lt.argmax(-1))
            logits.append(lt)
        attn = Attention(16, 2, 1, 8)
        windowed = init_kv_cache(1, 8, 1, 8, torch.float32)._replace(window=4)
        try:
            attention_decode(attn, torch.zeros(1, 1, 16), windowed,
                             n_heads=2, n_kv_heads=1, head_dim=8,
                             rope_theta=1e4)
            refusal = ""
        except ValueError as e:
            refusal = str(e)
    slots = [kv.k.shape[1] for kv in (cache.kv or cache.shared_kv)]
    return torch.stack(logits), slots, refusal


def placements_rank(rank, mesh, cases):
    """cases: [(shape, spec)] -> per case the local shape of the tensor
    distributed with ``to_placements(spec)``, then ``shard_hidden`` of a
    DTensor and of a plain tensor under ``train_rules``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import axis_ctx, shard_hidden, train_rules
    from repro_torch.distributed.sharding import to_placements
    shapes = []
    for shape, spec in cases:
        t = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        d = distribute_tensor(t, mesh, to_placements(spec, mesh))
        shapes.append(tuple(d.to_local().shape))
    x = torch.arange(8 * 4 * 6.0).reshape(8, 4, 6)
    d = distribute_tensor(x, mesh, to_placements((None, None, None), mesh))
    with axis_ctx(train_rules(False)):
        moved = shard_hidden(d, "batch", "seq", "act_hidden")
        plain = shard_hidden(x, "batch", "seq", "act_hidden")
    return dict(shapes=shapes, hidden=tuple(moved.to_local().shape),
                placements=tuple(moved.placements),
                full=moved.full_tensor(), plain_is_x=plain is x)


def transfer_rank(rank, mesh, xs_sets, bits_list, baf, w, sel):
    """For each xs of ``xs_sets``, pod ``rank`` sends xs[rank] (B, S, D)
    float32: the whole stream at each of ``bits_list``, and the channels
    ``sel`` restored with the stream BaF predictor ``baf`` (numpy leaves)
    and the block t @ w -> per set what this pod received and the bytes
    it handed to ``ppermute`` for each transfer."""
    from repro_torch.bridge import baf_stream_from_jax
    from repro_torch.core.baf import BaFStreamConfig
    from repro_torch.distributed import pipeline
    sent = []
    real = pipeline.ppermute

    def counted(t, perm, group):
        sent[-1] += t.numel() * t.element_size()
        return real(t, perm, group)
    pipeline.ppermute = counted
    cfg = BaFStreamConfig(c=len(sel), d_in=w.shape[0],
                          hidden=baf["l1"]["w"].shape[1])
    model = baf_stream_from_jax(baf, cfg, device="cpu")
    wt = torch.from_numpy(w)
    out = []
    for xs in xs_sets:
        x = torch.from_numpy(xs[rank])
        sent.clear()
        full = {}
        for bits in bits_list:
            sent.append(0)
            full[bits] = pipeline.compressed_pod_transfer(
                x, mesh, bits=bits, dtype=torch.float32)
        sent.append(0)
        subset = pipeline.subset_pod_transfer(
            x, mesh, sel_idx=torch.from_numpy(sel), baf=model,
            forward_fn=lambda t: t @ wt, bits=8, dtype=torch.float32)
        out.append(dict(full=full, subset=subset, sent=list(sent)))
    return out


def multipod_rank(rank, mesh, runs, params_file):
    """runs: [(arch, microbatches, batches)] -> per run the losses of the
    port's multi-pod step (grad_compress_bits=8, float32), one a batch, on
    the master weights saved in ``params_file`` under the arch's name, and
    this pod's weights and residuals after the last step."""
    from repro_torch import configs
    from repro_torch.train import trainer as tr
    masters = torch.load(params_file, weights_only=False)
    out = []
    for arch, mb, batches in runs:
        cfg = configs.get_smoke_config(arch).with_(dtype=torch.float32)
        tcfg = tr.TrainConfig(num_microbatches=mb, grad_compress_bits=8,
                              peak_lr=1e-2, warmup_steps=0, total_steps=10)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in masters[arch].items()}
        state = tr.init_train_state(params, tcfg)
        step = tr.make_train_step(cfg, tcfg, mesh=mesh, multi_pod=True)
        losses = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        out.append(dict(losses=losses, params=state.params, ef=state.ef))
    return out


def _gathered(tree):
    """``tree`` with every DTensor leaf replaced by its whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_gathered(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gathered(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return tree


def cell_args(cell, params, inputs) -> tuple:
    """``cell``'s arguments from JAX ``init_lm``/``init_encdec`` params
    (numpy leaves, carried across by ``bridge.master_from_jax``) and numpy
    ``inputs``: a train state on the float32 masters, serving weights in
    the cell's dtypes, the batch cast to its specs' dtypes, empty caches
    (whisper's cross K/V from ``inputs["enc"]``)."""
    from repro_torch.bridge import encdec_from_jax, master_from_jax
    from repro_torch.launch.specs import _cache_len
    from repro_torch.models.encdec import init_encdec_cache
    from repro_torch.models.lm import init_decode_cache
    from repro_torch.train.trainer import init_train_state
    cfg, args = cell.cfg, cell.args
    master = master_from_jax(params, cfg, device="cpu")

    def batch(spec: dict) -> dict:
        return {k: torch.from_numpy(inputs[k]).to(v.dtype)
                for k, v in spec.items()}
    if cell.kind == "train":
        return init_train_state(master, cell.tcfg), batch(args[1])
    weights = {k: v.detach().to(args[0][k].dtype) for k, v in master.items()}
    if cell.kind == "prefill":
        return weights, batch(args[1])
    if cell.kind == "long":
        return weights, batch({"tokens": args[1]})["tokens"]
    b, slots = args[2].shape[0], _cache_len(args[1])
    if cfg.family == "audio":
        with torch.no_grad():
            cache = init_encdec_cache(
                encdec_from_jax(params, cfg, device="cpu"),
                torch.from_numpy(inputs["enc"]).to(cfg.dtype), slots)
    else:
        cache = init_decode_cache(cfg, b, slots, device="cpu")
    return weights, cache, batch({"token": args[2]})["token"]


def cells_rank(rank, mesh, cases, systems):
    """cases: [(arch, shape name, shape, overrides)], systems: per case
    (JAX params, numpy inputs) -> per case the outputs (whole) of the
    arch's smoke cell in float32 cut to ``shape``, its arguments
    (``cell_args``) placed on ``mesh`` by the cell's placements;
    multi-pod when the pod axis is longer than 1, else on the reference's
    (data, model) mesh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    multi_pod = mesh.size(0) > 1
    if not multi_pod:
        mesh = mesh["data", "model"]
    out = []
    for (arch, shape_name, shape, overrides), (params, inputs) in zip(
            cases, systems):
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        cell = specs.build_cell(arch, shape_name, mesh, multi_pod=multi_pod,
                                overrides=overrides, cut=(cfg, shape))
        args = cell_args(cell, params, inputs)
        res = cell.fn(*specs.place(args, cell.in_placements, mesh))
        out.append(_gathered(res))
    return out


def wrappers_rank(rank, mesh, cases):
    """cases: [(q, k, v) numpy float32] for flash and [(q, k, v, ld, u,
    s0)] for the scan -> per case the wrapper's output on DTensors (the
    batch over "data", the heads over "model"), gathered whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.linear_scan import linear_scan
    mesh = mesh["data", "model"]
    bh = [Shard(0), Shard(2)]

    def place(a, placements):
        return distribute_tensor(torch.from_numpy(a), mesh, placements,
                                 src_data_rank=None)
    flash_cases, scan_cases = cases
    out = {"flash": [], "scan": []}
    for q, k, v in flash_cases:
        o = flash_attention(place(q, bh), place(k, bh), place(v, bh))
        out["flash"].append(o.full_tensor())
    for q, k, v, ld, u, s0 in scan_cases:
        y, st = linear_scan(place(q, bh), place(k, bh), place(v, bh),
                            place(ld, bh), bonus=place(u, [Replicate(),
                                                           Shard(0)]),
                            initial_state=place(s0, [Shard(0), Shard(1)]),
                            chunk=4)
        out["scan"].append((y.full_tensor(), st.full_tensor()))
    return out
