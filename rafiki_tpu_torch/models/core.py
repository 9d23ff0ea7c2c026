"""Shared building blocks, in the JAX package's layouts.

Counterpart of ``rafiki_tpu/models/core.py``. Weights are f32 masters;
``cast_for_compute`` brings activations to bf16 and each layer casts its
weights to the activation's type, as the JAX forward does. Dense kernels
are (in, out), not ``nn.Linear``'s (out, in). Activations are NHWC, as
there. A :class:`Conv2d` holds its kernel as OIHW in ``channels_last``
memory (cuDNN's layout, which is OHWI in memory); the JAX tree's HWIO
kernel is permuted on the way in and out (``convert.py``). The ViT's
patchify kernel stays HWIO (:class:`PatchEmbed`): it is one product.

The initializers draw from a ``numpy.random.Generator`` and return numpy
arrays in the JAX layout (the same fan scalings as the JAX package, not
its random numbers), so one seeded tree feeds both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, object]


# ---------------------------------------------------------------------------
# initializers (numpy, JAX layout)
# ---------------------------------------------------------------------------

def xavier_uniform(rng: np.random.Generator, shape: Sequence[int],
                   fan_in: int, fan_out: int) -> np.ndarray:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, tuple(shape)).astype(np.float32)


def dense_init(rng: np.random.Generator, in_dim: int, out_dim: int) -> Tree:
    return {"kernel": xavier_uniform(rng, (in_dim, out_dim), in_dim, out_dim),
            "bias": np.zeros((out_dim,), np.float32)}


def layernorm_init(dim: int) -> Tree:
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def conv2d_init(rng: np.random.Generator, kh: int, kw: int, cin: int,
                cout: int) -> Tree:
    std = math.sqrt(2.0 / (kh * kw * cin))  # He normal
    return {"kernel": (rng.standard_normal((kh, kw, cin, cout))
                       * std).astype(np.float32),
            "bias": np.zeros((cout,), np.float32)}


def normal_init(rng: np.random.Generator, shape: Sequence[int],
                std: float = 0.02) -> np.ndarray:
    return (rng.standard_normal(tuple(shape)) * std).astype(np.float32)


def embedding_init(rng: np.random.Generator, vocab: int, dim: int,
                   std: float = 0.02) -> Tree:
    return {"table": normal_init(rng, (vocab, dim), std)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def cast_for_compute(x: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return x.to(dtype)


def dense(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias, kernel (in, out), in x's type."""
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def layernorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32 (biased variance, as ``jnp.var``), result in x's
    type."""
    y = F.layer_norm(x.float(), x.shape[-1:], params["scale"],
                     params["bias"], eps)
    return y.to(x.dtype)


def dropout(rng, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """``x`` with each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``: the JAX package's ``core.dropout``,
    its mask ``jax.random.bernoulli(rng, 1 - rate, x.shape)`` bit for bit
    (drawn on the host, ``utils/jrandom.py``; ``rng`` a key there). Under
    a train mesh ``x`` is this rank's shard of a (batch, sequence, ...)
    activation, its rows on ``data`` and positions on ``seq``: the mask
    is the same region of the global draw."""
    if deterministic or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout needs a key (rng) when not deterministic")
    from rafiki_tpu_torch.parallel.sharding import current_mesh
    from rafiki_tpu_torch.utils import jrandom

    shape, region = tuple(x.shape), None
    mesh = current_mesh()
    if mesh is not None:
        shape, region = list(shape), [slice(None)] * x.dim()
        for dim, axis in ((0, "data"), (1, "seq")):
            n, at = mesh.size(axis), mesh.index(axis)
            region[dim] = slice(at * shape[dim], (at + 1) * shape[dim])
            shape[dim] *= n
    keep = jrandom.bernoulli(rng, 1.0 - rate, shape, region)
    keep = torch.from_numpy(np.ascontiguousarray(keep)).to(x.device)
    # JAX divides by the weakly typed 1 - rate in x's own type
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, 0.0).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def embedding(params: Mapping[str, torch.Tensor], ids: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[ids]


def patch_project(params: Mapping[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """The ViT patchify convolution (NHWC, HWIO kernel, stride = kernel,
    VALID padding) as a reshape and one product: (B, H, W, C) ->
    (B, H/p * W/p, dim). Exact, and free of cuDNN's TF32 default."""
    kernel = params["kernel"]
    p, _, c, dim = kernel.shape
    b, h, w, _ = x.shape
    patches = (x.reshape(b, h // p, p, w // p, p, c)
               .permute(0, 1, 3, 2, 4, 5)
               .reshape(b, (h // p) * (w // p), p * p * c))
    y = patches @ kernel.reshape(p * p * c, dim).to(x.dtype)
    return y + params["bias"].to(x.dtype)


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high), the odd
    pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, window: Tuple[int, int], stride: int,
              padding: str, value: float = 0.0) -> torch.Tensor:
    """``x`` (N, C, H, W) padded as XLA pads ``padding`` ("SAME" or
    "VALID") for ``window`` at ``stride``."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                         f"{padding!r}")
    top, bottom = same_pads(x.shape[2], window[0], stride)
    left, right = same_pads(x.shape[3], window[1], stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def hwio_to_oihw(kernel: torch.Tensor) -> torch.Tensor:
    """A JAX HWIO conv kernel as OIHW in ``channels_last`` memory."""
    return kernel.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def oihw_to_hwio(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(2, 3, 1, 0).contiguous()


def conv2d(params: Mapping[str, torch.Tensor], x: torch.Tensor,
           stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """``jax.lax.conv_general_dilated`` over NHWC ``x`` with the kernel
    (OIHW, ``channels_last``) and bias cast to x's type: (N, H, W, C) ->
    (N, H', W', O). ``"SAME"`` pads as XLA does, the odd pixel low-right
    (a 3x3/2 conv on 32 px pads (0, 1), not ``padding=1``'s (1, 1)). The
    NCHW view of NHWC memory is already ``channels_last``: no copy on
    either side."""
    kernel = params["kernel"]
    y = F.conv2d(_pad_nchw(x.permute(0, 3, 1, 2), kernel.shape[2:], stride,
                           padding),
                 kernel.to(x.dtype), params["bias"].to(x.dtype),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """``reduce_window(x, -inf, max, ...)`` over NHWC ``x``; ``"SAME"``
    pads with -inf as XLA does."""
    y = F.max_pool2d(_pad_nchw(x.permute(0, 3, 1, 2), (window, window),
                               stride, padding, float("-inf")),
                     window, stride)
    return y.permute(0, 2, 3, 1)


def mean_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``reduce_window(x, 0, add, ..., "VALID") / window**2`` over NHWC
    ``x``."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def own_params(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A module's direct parameters by name: the mapping the functions
    above take."""
    return dict(module.named_parameters(recurse=False))


class Dense(torch.nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = torch.nn.Parameter(torch.empty(in_dim, out_dim, **f32))
        self.bias = torch.nn.Parameter(torch.empty(out_dim, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(own_params(self), x)


class Conv2d(torch.nn.Module):
    """A convolution's parameters: kernel (O, I, H, W) in ``channels_last``
    memory, bias (O,)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = torch.nn.Parameter(torch.empty(
            cout, cin, kh, kw, **f32).contiguous(
                memory_format=torch.channels_last))
        self.bias = torch.nn.Parameter(torch.empty(cout, **f32))

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
        return conv2d(own_params(self), x, stride, padding)


class Embedding(torch.nn.Module):
    """A token embedding's parameters: table (vocab, dim)."""

    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.table = torch.nn.Parameter(
            torch.empty(vocab, dim, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return embedding(own_params(self), ids, dtype)


class LayerNorm(torch.nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = torch.nn.Parameter(torch.empty(dim, **f32))
        self.bias = torch.nn.Parameter(torch.empty(dim, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(own_params(self), x)


class PatchEmbed(torch.nn.Module):
    """The patchify convolution's parameters: kernel (p, p, C, dim)."""

    def __init__(self, patch: int, channels: int, dim: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = torch.nn.Parameter(
            torch.empty(patch, patch, channels, dim, **f32))
        self.bias = torch.nn.Parameter(torch.empty(dim, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_project(own_params(self), x)
