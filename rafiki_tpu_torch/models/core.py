"""Shared building blocks, in the JAX package's layouts.

Counterpart of ``rafiki_tpu/models/core.py``. Weights are f32 masters;
``cast_for_compute`` brings activations to bf16 and each layer casts its
weights to the activation's type, as the JAX forward does. Dense kernels
are (in, out), not ``nn.Linear``'s (out, in); convolution kernels are HWIO
over NHWC activations.

The initializers draw from a ``numpy.random.Generator`` and return numpy
arrays in the JAX layout (the same fan scalings as the JAX package, not
its random numbers), so one seeded tree feeds both packages.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

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
