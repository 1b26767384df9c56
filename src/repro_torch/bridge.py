"""Carry the JAX package's weights into the port's modules.

The JAX package draws its weights from ``jax.random``, which torch cannot
reproduce, so parity checks move the same weights across. The caller hands
in the param pytrees as numpy (for example ``jax.tree.map(np.asarray,
params)``); this module never imports JAX. Conv kernels go from HWIO to
OIHW; BN statistics, PReLU slopes and dense weights are copied as they are.
LM and encoder-decoder params keep the JAX (in, out) weight layout; their
layers, stacked on a leading axis by the JAX package, go one slice to each
layer module (MoE experts stay stacked within a layer), and each leaf is
cast to the dtype its module stores it in; ``master_from_jax`` gives the
trainer the same leaves as float32 tensors by parameter name. The stream
BaF predictor and the task heads keep
the JAX param tree's names; their dense layers' ``w``/``b`` go to
``weight``/``bias``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.baf import (BaFConv, BaFConvConfig, BaFStream,
                                  BaFStreamConfig)
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.nn import Dense
from repro_torch.tasks.heads import HeadConfig, get_head


def _copy(dst: torch.Tensor, src) -> None:
    arr = np.asarray(src, np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(arr).to(dst.dtype))


def _load_conv(conv, p: dict) -> None:
    _copy(conv.weight, np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if conv.bias is not None:
        _copy(conv.bias, p["b"])


def _load_bn(bn, p: dict) -> None:
    for k in ("scale", "bias", "mean", "var"):
        _copy(getattr(bn, k), p[k])


def _load_conv_bn(layer, p: dict) -> None:
    _load_conv(layer.conv, p["conv"])
    _load_bn(layer.bn, p["bn"])


def cnn_from_jax(params, cfg: CNNConfig, *, device=None) -> CNN:
    """JAX ``init_cnn`` params (numpy leaves) -> :class:`CNN`."""
    model = CNN(cfg, device=device)
    if len(params["stem"]) != len(model.stem) or \
            len(params["tail"]) != len(model.tail):
        raise ValueError("param tree does not match the CNN config")
    for layer, p in zip(model.stem, params["stem"]):
        _load_conv_bn(layer, p)
    _load_conv_bn(model.split, params["split"])
    for layer, p in zip(model.tail, params["tail"]):
        _load_conv_bn(layer, p)
    _copy(model.head.weight, params["head"]["w"])
    _copy(model.head.bias, params["head"]["b"])
    return model


def baf_from_jax(params, cfg: BaFConvConfig, *, device=None) -> BaFConv:
    """JAX ``init_baf_conv`` params (numpy leaves) -> :class:`BaFConv`."""
    model = BaFConv(cfg, device=device)
    for name in ("up", "c2", "c3", "c4"):
        _load_conv(getattr(model, name), params[name])
    for name in ("up_act", "c2_act", "c3_act"):
        _copy(getattr(model, name).alpha, params[name]["alpha"])
    return model


def baf_stream_from_jax(params, cfg: BaFStreamConfig, *,
                        device=None) -> BaFStream:
    """JAX ``init_baf_stream`` params (numpy leaves) -> :class:`BaFStream`
    (dense ``w``/``b`` into ``weight``/``bias``, PReLU ``alpha``)."""
    model = BaFStream(cfg, device=device)
    n = _load_tree(model, params)
    if n != len(list(model.parameters())):
        raise ValueError(f"{n} leaves for {len(list(model.parameters()))} "
                         f"weights")
    return model


def _load_tree(module: torch.nn.Module, tree: dict, index=None) -> int:
    """Copy a param dict into the same-named attributes of ``module`` (a
    dense layer's ``w``/``b`` into its ``weight``/``bias``), taking slice
    ``index`` of every leaf when the layers are stacked; returns the number
    of leaves copied."""
    n = 0
    for key, val in tree.items():
        dst = getattr(module, key)
        if isinstance(dst, Dense):
            val = {"weight": val["w"], "bias": val["b"]}
        if isinstance(val, dict):
            n += _load_tree(dst, val, index)
        else:
            _copy(dst, val if index is None else np.asarray(val)[index])
            n += 1
    return n


def _load_stacked(model: torch.nn.Module, params, stacks) -> None:
    """Each stack of layers one slice a layer module, then the rest."""
    for name in stacks:
        for i, layer in enumerate(getattr(model, name)):
            _load_tree(layer, params[name], i)
    _load_tree(model, {k: v for k, v in params.items() if k not in stacks})


def lm_from_jax(params, cfg: ArchConfig, *, device=None) -> LM:
    """JAX ``init_lm`` params (numpy leaves, layers stacked on axis 0) ->
    :class:`LM`: the dense, vlm, moe (experts stacked (E, ...) in each
    layer), ssm and hybrid (Mamba-2 layers and the ``shared`` block)
    families."""
    model = LM(cfg, device=device)
    _load_stacked(model, params, ("layers",))
    return model


def encdec_from_jax(params, cfg: ArchConfig, *, device=None) -> EncDec:
    """JAX ``init_encdec`` params (numpy leaves, encoder and decoder layers
    stacked on axis 0) -> :class:`EncDec`."""
    model = EncDec(cfg, device=device)
    _load_stacked(model, params, ("enc_layers", "dec_layers"))
    return model


def _jax_leaf(params, name: str, stacks):
    """The JAX leaf of the port's parameter ``name``: ``layers.3.attn.wq``
    is slice 3 of ``params["layers"]["attn"]["wq"]``."""
    parts = name.split(".")
    tree, index = params, None
    if parts[0] in stacks:
        tree, index, parts = params[parts[0]], int(parts[1]), parts[2:]
    for key in parts:
        tree = tree[key]
    arr = np.asarray(tree, np.float32)
    return arr if index is None else arr[index]


def master_from_jax(params, cfg: ArchConfig, *, device=None) -> dict:
    """JAX ``init_lm`` or (for the audio family) ``init_encdec`` params
    (numpy leaves, layers stacked on axis 0) -> the trainer's float32
    master weights: the port's parameter name -> tensor on ``device``
    (``None`` = the card), ``requires_grad=True``. The JAX package keeps
    its params in ``param_dtype`` float32 too; every leaf is used once."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        skeleton, stacks = EncDec(cfg, device="meta"), ("enc_layers",
                                                        "dec_layers")
    else:
        skeleton, stacks = LM(cfg, device="meta"), ("layers",)
    out = {}
    for name, p in skeleton.named_parameters():
        arr = _jax_leaf(params, name, stacks)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {arr.shape} does not fit "
                             f"{tuple(p.shape)}")
        out[name] = torch.tensor(arr, device=dev).requires_grad_(True)
    n_jax = sum(np.asarray(a).shape[0] if k in stacks else 1
                for k, a in _leaves(params))
    if n_jax != len(out):
        raise ValueError(f"{n_jax} JAX leaves (layers counted one by one) "
                         f"for {len(out)} parameters")
    return out


def _leaves(tree, top=None):
    """(top-level key, leaf) over a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, top or k)
        else:
            yield top or k, v


def heads_from_jax(head_bank: dict, cfg: HeadConfig, *, device=None) -> dict:
    """JAX ``init_head_bank`` bank (numpy leaves) -> the port's bank
    ``{task: head module}`` on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    out = {}
    for name, tree in head_bank.items():
        module = get_head(name).init(None, cfg)
        n = _load_tree(module, tree)
        if n != len(list(module.parameters())):
            raise ValueError(f"head {name!r}: {n} leaves for "
                             f"{len(list(module.parameters()))} weights")
        out[name] = module.to(dev)
    return out
