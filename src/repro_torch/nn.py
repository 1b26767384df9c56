"""Layers of the split CNN, the BaF predictor and the LM zoo.

Counterpart of ``repro/nn.py`` for the layers the port uses: conv,
conv-transpose, inference and training BN and the inverse BN, leaky ReLU,
PReLU, dense (channel-last (B, H, W, C)), and for the LMs RMSNorm (also
with the reference's low-memory backward), LayerNorm and squared ReLU over
the last dim, computed in float32 and cast back.
Public tensors stay NHWC as in the JAX package. Convolutions run on the
NCHW view ``x.permute(0, 3, 1, 2)`` of the NHWC tensor, which PyTorch
treats as ``channels_last`` memory, so no layout copy is made.

Parity with XLA, which the tests hold at 1e-5:

* ``conv_apply`` pads like XLA's ``"SAME"``: total ``max((ceil(n/s)-1)*s
  + k - n, 0)``, half before and the rest after. A 3x3 stride-2 conv on an
  even size pads (0, 1), which ``F.conv2d(padding=1)`` does not.
* ``conv_transpose_apply`` is ``lax.conv_transpose(..., "SAME")`` with the
  kernel not flipped: a correlation with the kernel over the input
  zero-dilated by the stride and padded (2, 1) for k=3, s=2. It runs here as
  ``F.conv_transpose2d`` with the flipped, transposed kernel, cropped to the
  SAME output size.
* leaky ReLU slope 0.1, BN eps 1e-5, ``batchnorm_inverse`` floors |scale|
  at 1e-6.
* Training BN normalises by the biased batch variance and moves the
  running stats by EMA with momentum 0.97, written out
  (``F.batch_norm`` keeps the unbiased variance).
* Leaky ReLU and PReLU are ``torch.where(x >= 0, ...)``, so the gradient
  at exactly 0 is the ``x`` branch's, as ``jnp.where`` gives it
  (``F.leaky_relu`` takes the other branch there).

Weights are stored OIHW and built frozen (``requires_grad=False``); a
trainer sets ``requires_grad_(True)`` on the module it trains. Initialisers
draw from an explicit ``torch.Generator`` with the JAX package's fan-in
scales; they cannot reproduce ``jax.random``, so parity tests bridge
weights (``bridge.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_ALPHA = 0.1
BN_EPS = 1e-5
BN_MOMENTUM = 0.97


# ---------------------------------------------------------------------------
# Initialisers (fan-in scaling as in repro/nn.py)
# ---------------------------------------------------------------------------

def he_normal(shape, fan_in: int, gen: torch.Generator | None) -> torch.Tensor:
    return math.sqrt(2.0 / max(fan_in, 1)) * torch.randn(shape, generator=gen)


def lecun_normal(shape, fan_in: int,
                 gen: torch.Generator | None) -> torch.Tensor:
    return math.sqrt(1.0 / max(fan_in, 1)) * torch.randn(shape, generator=gen)


def seeded(device: torch.device, seed: int) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; None on the ``meta``
    device, whose tensors have no values to draw."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def normal(shape, std: float = 0.02, *, gen: torch.Generator | None = None,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """``std * N(0, 1)`` drawn in float32 on ``device`` (the generator's
    device), then cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


# ---------------------------------------------------------------------------
# Functional layers on NHWC tensors
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               *, stride: int = 1) -> torch.Tensor:
    """SAME conv. x: (B, H, W, Cin); w: (Cout, Cin, k, k) -> (B, H', W', Cout)."""
    k = w.shape[-1]
    ph = _same_pads(x.shape[1], k, stride)
    pw = _same_pads(x.shape[2], k, stride)
    xc = x.permute(0, 3, 1, 2)
    if any(ph) or any(pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_transpose_apply(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor | None = None, *,
                         stride: int = 2) -> torch.Tensor:
    """``lax.conv_transpose(x, w, (s, s), "SAME")`` with an OIHW kernel.

    XLA correlates ``w`` (not flipped) with the input dilated by ``s`` and
    padded (2, 1) for k=3, s=2. ``F.conv_transpose2d`` with no padding
    computes the same correlation padded (k-1, k-1) with the kernel flipped,
    so it takes ``w`` flipped and transposed, and its output is cropped to
    the SAME size ``n * s`` from the front.
    """
    k = w.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    crop = (k - 1) - pad_a                      # rows dropped from the front
    wt = w.flip(-2, -1).transpose(0, 1)         # (Cin, Cout, k, k)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, b, stride=stride)
    h, wd = x.shape[1] * stride, x.shape[2] * stride
    y = y[:, :, crop:crop + h, crop:crop + wd]
    return y.permute(0, 2, 3, 1)


def dense_apply(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b); w: (in, out) as in the JAX package."""
    y = x @ w
    return y + b if b is not None else y


def batchnorm_apply(p: dict, x: torch.Tensor, *, eps: float = BN_EPS):
    """Inference BN over the trailing channel dim, XLA's operation order."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["scale"] + p["bias"]


def batchnorm_train_apply(p: dict, x: torch.Tensor, *, eps: float = BN_EPS,
                          momentum: float = BN_MOMENTUM):
    """Training BN over the trailing channel dim -> (y, new mean, new var).

    Normalises by the batch mean and the biased batch variance (``jnp.var``;
    ``F.batch_norm`` would fold the unbiased one into its running stats),
    and returns the running stats moved towards the batch's by EMA,
    ``m * old + (1 - m) * batch``, without gradient.
    """
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    var = (x - mean).square().mean(dim=dims)
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    with torch.no_grad():
        new_mean = momentum * p["mean"] + (1 - momentum) * mean
        new_var = momentum * p["var"] + (1 - momentum) * var
    return y, new_mean, new_var


def batchnorm_inverse(p: dict, z: torch.Tensor, *, eps: float = BN_EPS):
    """Pre-BN value from the BN output; |scale| < 1e-6 is floored to 1e-6."""
    scale = p["scale"]
    safe = torch.where(scale.abs() < 1e-6, torch.full_like(scale, 1e-6), scale)
    std = torch.sqrt(p["var"] + eps)
    return (z - p["bias"]) / safe * std + p["mean"]


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def prelu_apply(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


# ---------------------------------------------------------------------------
# Norms and activations of the LM zoo (last dim; float32 inside)
# ---------------------------------------------------------------------------

RMS_EPS = 1e-6
LN_EPS = 1e-5


def rmsnorm_apply(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = RMS_EPS) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast back."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


class _RMSNormLowMem(torch.autograd.Function):
    """``rmsnorm_apply`` whose backward keeps the cotangents in the input
    dtype; only the per-row statistics are float32. The counterpart of
    ``repro/nn.py::_rmsnorm_lowmem`` (a ``custom_vjp``), with its
    operations and roundings."""

    @staticmethod
    def forward(ctx, scale, x, eps):
        xf = x.float()
        inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(scale, x, inv)
        return (xf * inv * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        scale, x, inv = ctx.saved_tensors
        f32 = torch.float32
        gs = (g * scale.to(g.dtype)).to(x.dtype)
        dot = (gs.to(f32) * x.to(f32)).sum(dim=-1, keepdim=True)
        coef = (dot * inv * inv / x.shape[-1]).to(x.dtype)
        dx = ((gs.to(f32) - coef.to(f32) * x.to(f32)) * inv).to(x.dtype)
        dscale = (g.to(f32) * (x.to(f32) * inv)).sum(
            dim=tuple(range(x.ndim - 1))).to(scale.dtype)
        return dscale, dx, None


def rmsnorm_lowmem_apply(x: torch.Tensor, scale: torch.Tensor, *,
                         eps: float = RMS_EPS) -> torch.Tensor:
    """RMSNorm with cotangents in the input dtype (float32 row statistics
    only): the forward of :func:`rmsnorm_apply`, a leaner backward."""
    return _RMSNormLowMem.apply(scale, x, eps)


def layernorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with the population variance, in float32, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference weight: a parameter without gradient."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Modules holding the weights (built on the CPU; callers move them)
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """3x3 / 1x1 conv, weight (Cout, Cin, k, k); SAME padding."""

    def __init__(self, cin: int, cout: int, k: int, *, bias: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            he_normal((cout, cin, k, k), cin * k * k, gen),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(cout), requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return conv_apply(x, self.weight, self.bias, stride=stride)

    def transpose(self, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
        return conv_transpose_apply(x, self.weight, self.bias, stride=stride)


class BatchNorm(nn.Module):
    """BN with stored statistics (identity at init). ``scale`` and ``bias``
    are parameters (frozen until a trainer sets ``requires_grad``), the
    running ``mean`` and ``var`` buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = frozen(torch.ones(ch))
        self.bias = frozen(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def params(self) -> dict:
        return {"scale": self.scale, "bias": self.bias, "mean": self.mean,
                "var": self.var}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batchnorm_apply(self.params(), x)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """Batch-stat BN; the running stats take the EMA step in place."""
        y, mean, var = batchnorm_train_apply(self.params(), x)
        with torch.no_grad():
            self.mean.copy_(mean)
            self.var.copy_(var)
        return y


class PReLU(nn.Module):
    def __init__(self, ch: int, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((ch,), init), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu_apply(self.alpha, x)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, *,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((cin, cout), cin, gen),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim; ``scale`` in ``dtype`` (float32 in the LMs).
    ``lowmem``: the backward of :func:`rmsnorm_lowmem_apply`."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None,
                 lowmem: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.lowmem = lowmem

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.lowmem:
            return rmsnorm_lowmem_apply(x, self.scale)
        return rmsnorm_apply(x, self.scale)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with ``scale`` and ``bias``."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_apply(x, self.scale, self.bias)

