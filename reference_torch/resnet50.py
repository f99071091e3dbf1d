"""Plain reference of one ResNet-50 v1.5 training step (SGD with momentum).

The network is He, Zhang, Ren, Sun, "Deep Residual Learning for Image
Recognition", CVPR 2016, table 1, 50-layer column, in version 1.5 as
torchvision's ``resnet50`` and MLPerf Training's ResNet-50 have it:

* a 7x7/2 conv with padding 3 and 64 (``width``) filters, BN, ReLU;
* a 3x3/2 max pool with padding 1;
* four stages of (3, 4, 6, 3) bottlenecks at widths 64, 128, 256, 512:
  1x1 conv, BN, ReLU; 3x3 conv at the stage's stride (2 in the first
  block of stages 2-4, the v1.5 change: v1 strides the first 1x1), BN,
  ReLU; 1x1 conv to 4x the width, BN; a projection shortcut (1x1 conv at
  the stage's stride, BN) where the shape changes, else the identity; the
  sum, ReLU;
* a global average pool and an FC (with bias) to the classes; softmax
  cross-entropy, the mean over the batch.

Convs have no bias.  BN is in training mode: each channel normalized by
its mean and variance over N, H, W, then scaled and shifted.

Departures from the paper, each the port's and GxM's choice:

* the variance is E[x^2] - mean^2 (one pass over x for both moments), not
  the mean of squared deviations; epsilon is GxM's 1e-5;
* the running statistics are GxM's moving sums (FusedBNormXSMM.cpp):
  gmean = 0.9 gmean + mean, gvar = 0.9 gvar + nhw / (nhw - 1) var,
  scf = 0.9 scf + 1, read as gmean / scf and gvar / scf;
* SGD is GxM's: g' = g + wd p, m = mu m + g', p -= lr m, on every leaf
  (BN's scale and shift and the FC's bias too);
* the initial weights are whatever the caller gives (the benchmark's: the
  port's He init from a seed), not the paper's.

Everything is float32 in NCHW and KCRS, with TF32 off for matrix products
and cuDNN while a step runs.  Weights come from the port's tree by
``from_engine`` (its ``layers`` list: HWIO filters turned to KCRS, the FC's
[C, K] to [K, C]); they are plain tensors, so this file imports torch alone:
no kernel and no part of any package under test.

``conv_round`` (a float8 dtype) rounds every conv's operands, its input
and filter in the forward and the gradient at its output in the backward,
through that dtype with per-tensor scaling (the tensor's largest magnitude
taken to the format's largest value): the same step at a precision below
bfloat16, for setting the limits of a comparison.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = (3, 4, 6, 3)
EXPANSION = 4
EPS = 1e-5
MMF = 0.9


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and cuDNN, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def blocks() -> List[Tuple[str, int]]:
    """Each bottleneck's name and stride, in order."""
    return [(f"layer{si + 1}.{bi}", 2 if si > 0 and bi == 0 else 1)
            for si, n in enumerate(STAGES) for bi in range(n)]


def from_engine(layers) -> Dict[str, torch.Tensor]:
    """The port's parameter list (``params["layers"]`` of its ``resnet``
    at depth 50: the stem's conv and BN, the pool, one [main, shortcut]
    pair a bottleneck, the average pool, the FC) as named leaves, in
    the order of the network, convs KCRS and the FC [K, C], each in the
    dtype it had."""
    if len(layers) != 5 + len(blocks()):
        raise ValueError(f"{len(layers)} layers: not a ResNet-50")
    out: Dict[str, torch.Tensor] = {}

    def conv(name, p):
        out[name + ".w"] = p["w"].permute(3, 2, 0, 1).contiguous()

    def bn(name, p):
        out[name + ".gamma"], out[name + ".beta"] = p["gamma"], p["beta"]

    conv("conv1", layers[0])
    bn("bn1", layers[1])
    for (name, _), (main, short) in zip(blocks(), layers[3:-2]):
        for j in range(3):
            conv(f"{name}.conv{j + 1}", main[2 * j])
            bn(f"{name}.bn{j + 1}", main[2 * j + 1])
        if short:
            conv(f"{name}.downsample.0", short[0])
            bn(f"{name}.downsample.1", short[1])
    out["fc.w"] = layers[-1]["w"].t().contiguous()
    out["fc.b"] = layers[-1]["b"]
    return out


def bn_names(params: Dict[str, torch.Tensor]) -> List[str]:
    """The BN layers' names in the order of the network."""
    return [k[:-len(".gamma")] for k in params if k.endswith(".gamma")]


def _scaled_round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded through ``dtype`` with one scale for the tensor."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    q = (t.float() * scale).clamp(-top, top).to(dtype)
    return (q.float() / scale).to(t.dtype)


class _Round(torch.autograd.Function):
    """Rounded forward, the gradient passed through as it is."""

    @staticmethod
    def forward(ctx, t, dtype):
        return _scaled_round(t, dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Identity forward, the gradient rounded."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, ctx.dtype), None


def _conv(x, w, stride, rnd):
    pad = (w.shape[-1] - 1) // 2
    if rnd is not None:
        x, w = _Round.apply(x, rnd), _Round.apply(w, rnd)
    y = F.conv2d(x, w, stride=stride, padding=pad)
    return y if rnd is None else _RoundGrad.apply(y, rnd)


def _bn(x, gamma, beta, stats, name):
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    stats[name] = (mean.detach(), var.detach(), x.numel() // x.shape[1])
    x_hat = (x - mean[:, None, None]) * torch.rsqrt(var + EPS)[:, None, None]
    return x_hat * gamma[:, None, None] + beta[:, None, None]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
            conv_round: Optional[torch.dtype] = None):
    """(logits [N, classes], each BN's batch (mean, var, N * H * W) by
    name) of NCHW images ``x`` under named leaves ``p``."""
    stats: Dict[str, tuple] = {}
    y = _conv(x, p["conv1.w"], 2, conv_round)
    y = torch.relu(_bn(y, p["bn1.gamma"], p["bn1.beta"], stats, "bn1"))
    y = F.max_pool2d(y, 3, 2, padding=1)
    for name, stride in blocks():
        z = y
        for j, s in ((1, 1), (2, stride), (3, 1)):
            z = _conv(z, p[f"{name}.conv{j}.w"], s, conv_round)
            z = _bn(z, p[f"{name}.bn{j}.gamma"], p[f"{name}.bn{j}.beta"],
                    stats, f"{name}.bn{j}")
            if j < 3:
                z = torch.relu(z)
        if f"{name}.downsample.0.w" in p:
            y = _conv(y, p[f"{name}.downsample.0.w"], stride, conv_round)
            y = _bn(y, p[f"{name}.downsample.1.gamma"],
                    p[f"{name}.downsample.1.beta"], stats,
                    f"{name}.downsample.1")
        y = torch.relu(z + y)
    y = y.mean((2, 3))
    return y @ p["fc.w"].t() + p["fc.b"], stats


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


class Step(NamedTuple):
    loss: torch.Tensor                    # scalar
    params: Dict[str, torch.Tensor]       # after the step
    momentum: Dict[str, torch.Tensor]     # after the step
    running: Optional[Dict[str, tuple]]   # (gmean, gvar, scf) by BN name


def train_step(params: Dict[str, torch.Tensor],
               momentum: Dict[str, torch.Tensor], images: torch.Tensor,
               labels: torch.Tensor, *, lr: float = 0.1, mu: float = 0.9,
               wd: float = 1e-4, running: Optional[Dict[str, tuple]] = None,
               conv_round: Optional[torch.dtype] = None) -> Step:
    """One SGD step from (``params``, ``momentum``) on NHWC ``images`` and
    integer ``labels``: the loss, the leaves and momentum after it, and,
    where ``running`` (gmean, gvar, scf by BN name) is given, the running
    statistics after it."""
    with exact():
        leaves = {k: v.detach().float().clone().requires_grad_()
                  for k, v in params.items()}
        x = images.float().permute(0, 3, 1, 2).contiguous()
        with torch.enable_grad():
            logits, stats = forward(leaves, x, conv_round)
            loss = softmax_xent(logits, labels)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del logits, x
        with torch.no_grad():
            new_m, new_p = {}, {}
            for (k, p), g in zip(leaves.items(), grads):
                m = mu * momentum[k].float() + (g + wd * p)
                new_m[k], new_p[k] = m, p - lr * m
    new_running = None
    if running is not None:
        new_running = {}
        for name, (mean, var, nhw) in stats.items():
            gmean, gvar, scf = running[name]
            new_running[name] = (MMF * gmean + mean,
                                 MMF * gvar + nhw / (nhw - 1) * var,
                                 MMF * scf + 1.0)
    return Step(loss.detach(), new_p, new_m, new_running)

