"""Weight-only int8 quantization for the serving path.

Counterpart of ``rafiki_tpu/sdk/quant.py``. A large float kernel is
stored as int8 with one scale a channel (symmetric round-to-nearest,
+-max mapping to +-127, so each weight is off by at most half its
channel's scale), and each forward dequantizes it, in the source dtype,
ahead of the products that consume it; activations and accumulation keep
their usual dtype. ``DataParallelTrainer(serve_int8=True)`` or
``RAFIKI_SERVE_INT8=1`` turns it on for any SDK-trainer template
(``sdk/torch_backend.py``). The switch also governs trial-time
``evaluate``, so trials are chosen by the accuracy they will serve. It
is off by default, as in the JAX package.

The channels are those of the JAX layout: the scale is per last-axis
channel of the JAX tree's leaf (a dense kernel's output column, HWIO's
O, an embedding's feature column), and a transformer's per-layer leaves
are quantized as the JAX tree stacks them, over every layer at once
(:func:`quantize_module` through ``convert.jax_layout``). So for one
tree the int8 values and the scales equal the JAX package's, whatever
layout the port keeps them in (a torch conv kernel's output channel is
its axis 0).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

#: leaves with fewer elements pass through (their bytes are noise)
MIN_ELEMS = 4096


def serve_int8_enabled() -> bool:
    return os.environ.get("RAFIKI_SERVE_INT8") == "1"


def is_quantized_leaf(x: Any) -> bool:
    return (isinstance(x, dict) and set(x) == {"q", "scale"}
            and getattr(x["q"], "dtype", None) == torch.int8)


def _quantize_leaf(leaf: Any, min_elems: int) -> Any:
    """``{"q": int8, "scale": per last-axis channel, in the source
    dtype}`` for a float leaf of ndim >= 2 and at least ``min_elems``
    elements; any other leaf unchanged. The arithmetic is numpy's in f32
    (IEEE division, round half to even), on the leaf's device."""
    t = leaf if isinstance(leaf, torch.Tensor) else (
        torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else None)
    if (t is None or t.ndim < 2 or t.numel() < min_elems
            or not t.is_floating_point()):
        return leaf
    a = t.detach().float()
    amax = a.abs().amax(dim=tuple(range(a.ndim - 1)), keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    # the scale carries the SOURCE dtype, so a bf16 kernel comes back bf16
    return {"q": q, "scale": scale.to(t.dtype)}


def quantize_pytree(params: Any, min_elems: int = MIN_ELEMS) -> Any:
    """A tree (nested dicts and lists of tensors or numpy arrays) with
    each large float kernel replaced by its int8 leaf; biases, norms and
    small leaves pass through untouched."""
    if isinstance(params, dict):
        return {k: quantize_pytree(v, min_elems) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_pytree(v, min_elems) for v in params)
    return _quantize_leaf(params, min_elems)


def dequantize_pytree(qparams: Any) -> Any:
    """The inverse of :func:`quantize_pytree`: each int8 leaf as
    ``q * scale`` in its source dtype."""
    if is_quantized_leaf(qparams):
        scale = qparams["scale"]
        return qparams["q"].to(scale.dtype) * scale
    if isinstance(qparams, dict):
        return {k: dequantize_pytree(v) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(dequantize_pytree(v) for v in qparams)
    return qparams


def _leaves(tree: Any):
    if is_quantized_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(qparams: Any) -> int:
    """The serving weights' footprint in bytes, counted as the JAX
    package counts it (a scale at 4 bytes)."""
    total = 0
    for leaf in _leaves(qparams):
        if is_quantized_leaf(leaf):
            total += leaf["q"].numel() + leaf["scale"].numel() * 4
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def quantize_jax_layout(model: torch.nn.Module,
                        min_elems: int = MIN_ELEMS) -> Dict[str, Any]:
    """``model``'s parameters as the JAX package quantizes its tree:
    ``{tree path: leaf}`` in the JAX layout (a transformer's block leaves
    stacked over the layers, conv kernels HWIO), on the parameters'
    device."""
    from rafiki_tpu_torch.convert import jax_layout

    params = dict(model.named_parameters())
    out = {}
    for path, names, kind in jax_layout(model):
        ts = [params[n].detach() for n in names]
        leaf = (torch.stack(ts) if kind == "stack"
                else ts[0].permute(2, 3, 1, 0) if kind == "conv" else ts[0])
        out[path] = _quantize_leaf(leaf, min_elems)
    return out


def quantize_module(model: torch.nn.Module,
                    min_elems: int = MIN_ELEMS) -> Dict[str, Any]:
    """``{parameter name: tensor or int8 leaf}`` for ``model``, each int8
    leaf in the module's own layout and quantized in the JAX layout's
    axes (:func:`quantize_jax_layout`): a layer's slice of a stacked leaf
    keeps the scale shared by every layer, and a conv kernel is OIHW
    (``channels_last``) with its scale (O, 1, 1, 1). A parameter that
    passes through is the module's own tensor."""
    from rafiki_tpu_torch.convert import jax_layout

    params = dict(model.named_parameters())
    qtree = quantize_jax_layout(model, min_elems)
    out: Dict[str, Any] = {}
    for path, names, kind in jax_layout(model):
        leaf = qtree[path]
        if not is_quantized_leaf(leaf):
            out.update({n: params[n].detach() for n in names})
        elif kind == "stack":
            out.update({n: {"q": leaf["q"][i], "scale": leaf["scale"][0]}
                        for i, n in enumerate(names)})
        elif kind == "conv":
            out[names[0]] = {
                "q": leaf["q"].permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last),
                "scale": leaf["scale"].permute(3, 2, 0, 1)}
        else:
            out[names[0]] = leaf
    return out
