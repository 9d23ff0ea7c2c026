"""ResNet (v1.5 bottleneck and basic blocks) with BatchNorm.

Counterpart of ``rafiki_tpu/models/resnet.py``: the ImageNet stem (7x7/2
conv, 3x3/2 ``"SAME"`` max pool) or the CIFAR stem (``small_inputs``:
3x3/1 conv, no pool); stages of blocks whose first block strides by 2
(after the first stage) on the 3x3 conv; a projection shortcut where the
channels or the stride change; a global average pool and a dense head.
NHWC, bf16 compute, f32 logits.

BatchNorm is :func:`batchnorm`, a function on tensors as in the JAX
package, not ``nn.BatchNorm2d``: statistics in f32 over the bf16 conv
output, the result cast back to bf16; in training it normalises with the
batch's mean and *biased* variance and returns running statistics
``0.9 * running + 0.1 * batch`` (torch's BatchNorm keeps the unbiased
variance). The normalisation is ATen's fused batch-norm kernel (one
launch each way, f32 inside, over the ``channels_last`` view of the NHWC
activations); written out as the JAX function is, in f32 elementwise
passes, it cost a ResNet-50 step twice the launches and three times the
kernel time (PERF.md §6). The running statistics are the model's
*state*: registered buffers (``<bn>.mean``, ``<bn>.var``), which the
optimizer never sees (weight decay on them would corrupt them). :meth:`ResNet.forward` takes
the state as a mapping (default: its own buffers) and returns the new
state beside the logits; ``DataParallelTrainer(stateful=True)`` writes it
back after each step.

Over several ranks (a data group, ``parallel/ranks.py``) the training
moments are the global batch's, as under GSPMD in the JAX package, where
the mean and variance of a sharded batch are taken over all of it: each
rank sums its rows, the sums are added over the ranks (two passes, the
mean and then the squared deviations, in f32), and the gradient of each
sum is added over the ranks in the backward. The running statistics then
agree on every rank with no copy from rank 0. That path is the function
written out in f32 passes; ATen's fused kernels stay for one rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.parallel.ranks import current_group

State = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    bottleneck: bool = True
    width: int = 64
    num_classes: int = 1000
    small_inputs: bool = False  # CIFAR stem: 3x3/1 conv, no max pool


def resnet18(num_classes: int = 10, small_inputs: bool = True
             ) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False,
                        num_classes=num_classes, small_inputs=small_inputs)


def resnet50(num_classes: int = 1000, small_inputs: bool = False
             ) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                        num_classes=num_classes, small_inputs=small_inputs)


def batchnorm(p: Mapping[str, torch.Tensor], stats: Mapping[str, torch.Tensor],
              x: torch.Tensor, train: bool, momentum: float = 0.9,
              eps: float = 1e-5) -> Tuple[torch.Tensor, State]:
    """BatchNorm over the (N, H, W) dims of NHWC ``x``: (y in x's type,
    the new running statistics {mean, var}, detached).

    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, with the
    batch's mean and biased variance in training and the running ones in
    evaluation: ``aten::native_batch_norm`` computes exactly that for a
    bf16 input and f32 parameters, and hands back the batch mean and
    ``rsqrt(var + eps)``, from which the variance is recovered."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    group = current_group() if train else None
    if group is not None:
        y, mean, var = _global_batchnorm(xc, p["scale"], p["bias"], eps,
                                         group)
        with torch.no_grad():
            new_stats = {
                "mean": torch.add(stats["mean"] * momentum, mean,
                                  alpha=1 - momentum),
                "var": torch.add(stats["var"] * momentum, var,
                                 alpha=1 - momentum),
            }
    elif train:
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            xc, p["scale"], p["bias"], None, None, True, 0.0, eps)
        with torch.no_grad():
            var = invstd.pow(-2) - eps
            new_stats = {
                "mean": torch.add(stats["mean"] * momentum, mean,
                                  alpha=1 - momentum),
                "var": torch.add(stats["var"] * momentum, var,
                                 alpha=1 - momentum),
            }
    else:
        y = torch.ops.aten.native_batch_norm(
            xc, p["scale"], p["bias"], stats["mean"], stats["var"], False,
            0.0, eps)[0]
        new_stats = dict(stats)
    return y.permute(0, 2, 3, 1), new_stats


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over the ranks; its gradient is summed likewise."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.clone()), None


def _global_batchnorm(xc: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float, group
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, biased variance) of NCHW ``xc`` with the moments of the
    whole batch over the ranks' shards (equal on every rank)."""
    xf = xc.float()
    count = xf.numel() // xf.shape[1] * group.size
    dims = (0, 2, 3)
    mean = _SumOverRanks.apply(xf.sum(dims), group) / count
    dev = xf - mean[None, :, None, None]
    var = _SumOverRanks.apply((dev * dev).sum(dims), group) / count
    y = (dev * torch.rsqrt(var + eps)[None, :, None, None]
         * scale[None, :, None, None] + bias[None, :, None, None])
    return y.to(xc.dtype), mean.detach(), var.detach()


def _block_channels(cfg: ResNetConfig, stage: int) -> Tuple[int, int]:
    width = cfg.width * (2 ** stage)
    return width, (width * 4 if cfg.bottleneck else width)


def _blocks(cfg: ResNetConfig):
    """(name, cin, width, cout, stride, projected) of every block."""
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        width, cout = _block_channels(cfg, si)
        for bi in range(n_blocks):
            first = bi == 0 and si > 0
            yield (f"s{si}b{bi}", cin, width, cout, 2 if first else 1,
                   cin != cout or first)
            cin = cout


def _convs(cfg: ResNetConfig, cin: int = 0, width: int = 0, cout: int = 0):
    """(name, kernel size, cin, cout, its BatchNorm, whether it takes the
    block's stride) of a block's convolutions, in order: a bottleneck
    strides on its 3x3 (v1.5), a basic block on its first."""
    if cfg.bottleneck:
        return (("conv1", 1, cin, width, "bn1", False),
                ("conv2", 3, width, width, "bn2", True),
                ("conv3", 1, width, cout, "bn3", False))
    return (("conv1", 3, cin, width, "bn1", True),
            ("conv2", 3, width, cout, "bn2", False))


def _out_channels(cfg: ResNetConfig) -> int:
    return _block_channels(cfg, len(cfg.stage_sizes) - 1)[1]


def init(rng: np.random.Generator, cfg: ResNetConfig) -> Tuple[dict, dict]:
    """(params, batch_stats) trees in the JAX layout, numpy f32."""
    def bn(dim):
        return ({"scale": np.ones(dim, np.float32),
                 "bias": np.zeros(dim, np.float32)},
                {"mean": np.zeros(dim, np.float32),
                 "var": np.ones(dim, np.float32)})

    stem_k = 3 if cfg.small_inputs else 7
    params = {"stem": core.conv2d_init(rng, stem_k, stem_k, 3, cfg.width)}
    stats = {}
    params["stem_bn"], stats["stem_bn"] = bn(cfg.width)
    for name, cin, width, cout, _, projected in _blocks(cfg):
        blk, bst = {}, {}
        for conv, k, a, b, norm, _ in _convs(cfg, cin, width, cout):
            blk[conv] = core.conv2d_init(rng, k, k, a, b)
            blk[norm], bst[norm] = bn(b)
        if projected:
            blk["proj"] = core.conv2d_init(rng, 1, 1, cin, cout)
            blk["proj_bn"], bst["proj_bn"] = bn(cout)
        params[name], stats[name] = blk, bst
    params["head"] = core.dense_init(rng, _out_channels(cfg),
                                     cfg.num_classes)
    return params, stats


class BatchNorm(torch.nn.Module):
    """A BatchNorm's parameters (scale, bias) and running statistics
    (buffers mean, var)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = torch.nn.Parameter(torch.empty(dim, **f32))
        self.bias = torch.nn.Parameter(torch.empty(dim, **f32))
        self.register_buffer("mean", torch.empty(dim, **f32))
        self.register_buffer("var", torch.empty(dim, **f32))


class Block(torch.nn.Module):
    def __init__(self, cfg: ResNetConfig, cin: int, width: int, cout: int,
                 projected: bool, device=None):
        super().__init__()
        for conv, k, a, b, norm, _ in _convs(cfg, cin, width, cout):
            self.add_module(conv, core.Conv2d(k, k, a, b, device))
            self.add_module(norm, BatchNorm(b, device))
        if projected:
            self.proj = core.Conv2d(1, 1, cin, cout, device)
            self.proj_bn = BatchNorm(cout, device)


class ResNet(torch.nn.Module):
    """images (B, H, W, 3) -> (logits (B, num_classes) f32, new state)."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        stem_k = 3 if cfg.small_inputs else 7
        self.stem = core.Conv2d(stem_k, stem_k, 3, cfg.width, device)
        self.stem_bn = BatchNorm(cfg.width, device)
        for name, cin, width, cout, _, projected in _blocks(cfg):
            self.add_module(name, Block(cfg, cin, width, cout, projected,
                                        device))
        self.head = core.Dense(_out_channels(cfg), cfg.num_classes, device)

    def state(self) -> State:
        """The running statistics: this model's buffers, by name."""
        return dict(self.named_buffers())

    def forward(self, images: torch.Tensor, state: Optional[State] = None,
                train: bool = False) -> Tuple[torch.Tensor, State]:
        """``state`` (default: the buffers) supplies every BatchNorm's
        running statistics; the returned state holds the updated ones in
        training, the same ones in evaluation."""
        state = self.state() if state is None else state
        new_state: State = {}

        def bn(name: str, x: torch.Tensor) -> torch.Tensor:
            stats = {"mean": state[name + ".mean"],
                     "var": state[name + ".var"]}
            y, new = batchnorm(core.own_params(self.get_submodule(name)),
                               stats, x, train)
            new_state[name + ".mean"], new_state[name + ".var"] = (
                new["mean"], new["var"])
            return y

        cfg = self.cfg
        x = core.cast_for_compute(images)
        x = self.stem(x, stride=1 if cfg.small_inputs else 2)
        x = torch.relu(bn("stem_bn", x))
        if not cfg.small_inputs:
            x = core.max_pool(x, 3, 2, "SAME")
        for name, _, _, _, stride, projected in _blocks(cfg):
            blk = self.get_submodule(name)
            y = x
            convs = _convs(cfg)
            for i, (conv, _, _, _, norm, strides) in enumerate(convs):
                y = bn(f"{name}.{norm}", getattr(blk, conv)(
                    y, stride=stride if strides else 1))
                if i < len(convs) - 1:
                    y = torch.relu(y)
            residual = x
            if projected:
                residual = bn(f"{name}.proj_bn", blk.proj(x, stride=stride))
            x = torch.relu(y + residual)
        x = x.mean(dim=(1, 2))
        return self.head(x).float(), new_state
