"""Carry parameters between the JAX package's tree layout and the port's
modules.

The transformer families, ViT, BERT and the LM (:func:`from_jax_params`,
:func:`to_jax_params`): the JAX tree keeps the transformer blocks stacked
on a leading ``depth`` axis (``blocks/attn/wq`` is (depth, dim, heads,
dh)); the port splits it, one ``Block`` per layer
(``blocks.<i>.attn.wq``). Every other leaf keeps its JAX shape and
layout: ``embed/table`` (vocab, dim), ``pos`` (1, max_len, dim). The
LM's head is tied to ``embed/table`` and has no leaf of its own.

The image-classification zoo (:func:`from_jax_tree`, :func:`to_jax_tree`):
a tree path is the module path (``convs/3/kernel`` is ``convs.3.kernel``,
``layers/0/bias`` is ``layers.0.bias``, ``s1b0/proj_bn/scale`` is
``s1b0.proj_bn.scale``); a list in the JAX tree (``convs``, ``layers``)
is indexed by position. A :class:`~rafiki_tpu_torch.models.core.Conv2d`
kernel is HWIO there and OIHW (``channels_last``) here. The BatchNorm
state tree (``<bn>/mean``, ``<bn>/var``) maps to the buffers. Both
directions are exact.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.models.bert import Bert, BertConfig
from rafiki_tpu_torch.models.core import Conv2d, hwio_to_oihw, oihw_to_hwio
from rafiki_tpu_torch.models.lm import LM, LMConfig
from rafiki_tpu_torch.models.vit import ViT, ViTConfig

#: the module each transformer family's config builds
FAMILIES = {ViTConfig: ViT, BertConfig: Bert, LMConfig: LM}
from rafiki_tpu_torch.sdk.params import SEP, flatten, unflatten


def jax_tree_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-layout tree -> ``state_dict`` of CPU f32 tensors, with the
    stacked ``blocks`` split per layer."""
    state = {}
    for path, value in flatten(tree).items():
        value = np.asarray(value, np.float32)
        name = path.replace(SEP, ".")
        if path.startswith("blocks" + SEP):
            rest = name[len("blocks."):]
            for i, layer in enumerate(value):
                state[f"blocks.{i}.{rest}"] = torch.from_numpy(layer.copy())
        else:
            state[name] = torch.from_numpy(value.copy())
    return state


def from_jax_params(tree: Dict[str, Any], cfg, device=None,
                    train: bool = False) -> torch.nn.Module:
    """The module of ``cfg``'s family (a :class:`ViTConfig`,
    :class:`BertConfig` or :class:`LMConfig`) on ``device`` (the default
    device when None) holding the JAX-layout parameter ``tree``, in
    training mode when ``train`` (else in eval mode). Names and shapes are
    checked strictly."""
    dev = default_device(device)
    with torch.device("meta"):
        model = FAMILIES[type(cfg)](cfg)
    model.load_state_dict(jax_tree_to_state_dict(tree), strict=True,
                          assign=True)
    return model.to(dev).train(train)


def to_jax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: a numpy tree in the JAX
    layout, blocks stacked again."""
    flat: Dict[str, Any] = {}
    layers: Dict[str, list] = {}
    for name, value in model.state_dict().items():
        arr = value.detach().float().cpu().numpy()
        if name.startswith("blocks."):
            _, index, rest = name.split(".", 2)
            layers.setdefault(rest, []).append((int(index), arr))
        else:
            flat[name.replace(".", SEP)] = arr
    for rest, items in layers.items():
        flat["blocks" + SEP + rest.replace(".", SEP)] = np.stack(
            [a for _, a in sorted(items, key=lambda item: item[0])])
    return unflatten(flat)


def _conv_kernels(model: torch.nn.Module) -> set:
    return {f"{name}.kernel" if name else "kernel"
            for name, mod in model.named_modules() if isinstance(mod, Conv2d)}


def from_jax_tree(model: torch.nn.Module, params: Dict[str, Any],
                  state: Optional[Dict[str, Any]] = None, device=None,
                  train: bool = False) -> torch.nn.Module:
    """``model`` (built on the ``meta`` device) holding the JAX-layout
    ``params`` tree and, for a model with running statistics, the
    ``state`` tree; moved to ``device`` (the default device when None),
    in training mode when ``train``. Names and shapes are checked
    strictly."""
    dev = default_device(device)
    convs = _conv_kernels(model)
    sd = {}
    for tree in (params, state or {}):
        for path, value in flatten(tree).items():  # lists by index
            name = path.replace(SEP, ".")
            t = torch.from_numpy(np.array(value, np.float32))
            sd[name] = hwio_to_oihw(t) if name in convs else t
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).train(train)


def _unflatten_lists(tree: Any) -> Any:
    """Dicts keyed "0", "1", ... (lists flattened by index) as lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _unflatten_lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def to_jax_tree(model: torch.nn.Module) -> Tuple[Dict[str, Any],
                                                 Dict[str, Any]]:
    """(params, state) numpy trees in the JAX layout; ``state`` is empty
    for a model without running statistics."""
    convs = _conv_kernels(model)
    params, state = {}, {}
    buffers = {name for name, _ in model.named_buffers()}
    for name, value in model.state_dict().items():
        t = value.detach().float().cpu()
        t = oihw_to_hwio(t) if name in convs else t
        (state if name in buffers else params)[
            name.replace(".", SEP)] = t.numpy()
    return (_unflatten_lists(unflatten(params)),
            _unflatten_lists(unflatten(state)))
