"""The system under test: the port's CNN, BaF net, compression plan and
serving gateway, built from a configuration and loaded with the
benchmark's weights. The only module here that imports the port."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def load(module: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Copy ``weights[prefix + key]`` into every tensor of the module's
    state dict; the two key sets must be the same."""
    state = module.state_dict()
    mine = {k[len(prefix):] for k in weights if k.startswith(prefix)}
    if mine != set(state):
        raise KeyError(f"{prefix}: weights {sorted(mine ^ set(state))} do "
                       f"not match the port's module")
    with torch.no_grad():
        for key, t in state.items():
            src = weights[prefix + key]
            if src.shape != t.shape:
                raise ValueError(f"{prefix}{key}: {tuple(src.shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(src)


@dataclass
class Program:
    cnn: object
    baf: object
    plan: object
    edge: object                 # img (B, S, S, 3) -> z (B, H, W, P)
    cloud: object                # z~ (B, H, W, P) -> logits
    gateway: object = None


def build(cfg: dict, traffic: dict, weights: dict, sel: np.ndarray,
          device: torch.device) -> Program:
    """The port's objects for one cell, on ``device``."""
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
    load(cnn, weights, "cnn.")
    load(baf, weights, "baf.")
    op = pipeline.OperatingPoint(c=cfg["c"], bits=cfg["bits"],
                                 backend=traffic["backend"],
                                 tiling=cfg["tiling"])
    spec = pipeline.ModelSpec(sel_idx=sel, params=cnn, baf_params=baf)
    plan = pipeline.compile(op, spec, device=device)
    edge, cloud = cnn_fns(cnn)
    gateway = None
    if traffic["kind"] == "gateway_serve":
        from repro_torch.serve.gateway import ServingGateway
        gateway = ServingGateway(cnn, {cfg["c"]: (baf, sel)}, channel=None,
                                 default_op=op, max_batch=traffic["batch"],
                                 device=device)
    return Program(cnn, baf, plan, edge, cloud, gateway)


def to_device(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """One (1, S, S, 3) host frame on the device, as the gateway moves a
    request's image."""
    from repro_torch.core.split import to_device as port_to_device
    return port_to_device(frame, device)
