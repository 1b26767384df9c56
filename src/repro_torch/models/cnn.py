"""YOLO-v3-front CNN of the Tier-A reproduction.

Counterpart of ``repro/models/cnn.py``: the Darknet-53 stem through the
paper's split layer l=12 with a width multiplier. At width 1 and a 512x512
input the split tensor is the paper's 64x64x256 with Q=128.

  conv 32 s1 | conv 64 s2 | res(32,64) | conv 128 s2 | res(64,128) x2 |
  conv 256 s2 + BN  <- split layer (no activation on the edge)

The cloud applies the split layer's leaky ReLU, ``tail_res_blocks``
residual pairs, global average pooling and a dense head.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.device import resolve_device


class CNNConfig(NamedTuple):
    width_mult: float = 1.0
    input_size: int = 512
    num_classes: int = 8
    tail_res_blocks: int = 2

    def ch(self, c: int) -> int:
        return max(4, int(round(c * self.width_mult)))

    @property
    def split_p(self) -> int:      # P: channels of the split BN output
        return self.ch(256)

    @property
    def split_q(self) -> int:      # Q: input channels of the split conv
        return self.ch(128)

    @property
    def split_hw(self) -> int:     # spatial size of the split output
        return self.input_size // 8


# strides of the 9 stem convs; a residual pair is (1x1 a, 3x3 b)
STEM_STRIDES = (1, 2, 1, 1, 2, 1, 1, 1, 1)
STEM_RES_START = (2, 5, 7)        # shortcut taken before these indices
STEM_RES_END = (3, 6, 8)          # and added after these


class ConvBN(nn.Module):
    """Conv without bias followed by BN."""

    def __init__(self, cin: int, cout: int, k: int, *, gen=None):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, bias=False, gen=gen)
        self.bn = tnn.BatchNorm(cout)

    def forward(self, x: torch.Tensor, stride: int = 1, *,
                train: bool = False) -> torch.Tensor:
        y = self.conv(x, stride)
        return self.bn.forward_train(y) if train else self.bn(y)


class CNN(nn.Module):
    """Edge and cloud halves of the split CNN (NHWC in and out).

    ``seed`` draws the weights from a ``torch.Generator`` on the CPU (the
    same numbers on every device); ``device=None`` means the card.

    ``edge``, ``cloud`` and ``forward`` run without gradient and with the
    stored BN statistics, as the served path does. With ``train=True``
    they are the counterpart of ``cnn_forward_train``: batch-stat BN whose
    running stats take their EMA step in place, with gradients to every
    weight whose ``requires_grad`` is set.
    """

    def __init__(self, cfg: CNNConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        ch = cfg.ch
        self.cfg = cfg
        stem = [(3, ch(32), 3), (ch(32), ch(64), 3), (ch(64), ch(32), 1),
                (ch(32), ch(64), 3), (ch(64), ch(128), 3),
                (ch(128), ch(64), 1), (ch(64), ch(128), 3),
                (ch(128), ch(64), 1), (ch(64), ch(128), 3)]
        self.stem = nn.ModuleList(ConvBN(i, o, k, gen=gen) for i, o, k in stem)
        self.split = ConvBN(ch(128), ch(256), 3, gen=gen)
        tail = []
        for _ in range(cfg.tail_res_blocks):
            tail.append(ConvBN(ch(256), ch(128), 1, gen=gen))
            tail.append(ConvBN(ch(128), ch(256), 3, gen=gen))
        self.tail = nn.ModuleList(tail)
        self.head = tnn.Dense(ch(256), cfg.num_classes, gen=gen)
        self.to(dev)

    def edge(self, img: torch.Tensor, *, train: bool = False):
        """Mobile side: stem, then split conv + BN (no activation).

        img (B, S, S, 3) -> (x_in (B, S/4, S/4, Q), z (B, S/8, S/8, P)).
        """
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            x = img
            shortcut = None
            for i, (layer, s) in enumerate(zip(self.stem, STEM_STRIDES)):
                if i in STEM_RES_START:
                    shortcut = x
                x = tnn.leaky_relu(layer(x, s, train=train))
                if i in STEM_RES_END:
                    x = x + shortcut
            return x, self.split(x, 2, train=train)

    def cloud(self, z: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """Cloud side: leaky(z), tail residual pairs, GAP, dense head."""
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            x = tnn.leaky_relu(z)
            for i in range(0, len(self.tail), 2):
                sc = x
                x = tnn.leaky_relu(self.tail[i](x, train=train))
                x = tnn.leaky_relu(self.tail[i + 1](x, train=train))
                x = x + sc
            return self.head(x.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.cloud(self.edge(img)[1])

    def forward_train(self, img: torch.Tensor) -> torch.Tensor:
        """Counterpart of ``cnn_forward_train``: logits of the batch-stat
        forward; every BN's running stats take their EMA step."""
        return self.cloud(self.edge(img, train=True)[1], train=True)
