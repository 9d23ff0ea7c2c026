"""Carry parameters between the JAX package's tree layout and the port's
modules.

The JAX tree keeps the transformer blocks stacked on a leading ``depth``
axis (``blocks/attn/wq`` is (depth, dim, heads, dh)); the port splits it,
one ``Block`` per layer (``blocks.<i>.attn.wq``). Every other leaf keeps
its JAX shape and layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.models.vit import ViT, ViTConfig
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


def from_jax_params(tree: Dict[str, Any], cfg: ViTConfig, device=None,
                    train: bool = False) -> ViT:
    """A :class:`ViT` on ``device`` (the default device when None) holding
    the JAX-layout parameter ``tree``, in training mode when ``train``
    (else in eval mode). Names and shapes are checked strictly."""
    dev = default_device(device)
    with torch.device("meta"):
        model = ViT(cfg)
    model.load_state_dict(jax_tree_to_state_dict(tree), strict=True,
                          assign=True)
    return model.to(dev).train(train)


def to_jax_params(model: ViT) -> Dict[str, Any]:
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
