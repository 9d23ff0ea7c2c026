"""Carry parameters between the JAX package's tree layout and the port's
modules.

The transformer families, ViT, BERT and the LM (:func:`from_jax_params`,
:func:`to_jax_params`): the JAX tree keeps the transformer blocks stacked
on a leading ``depth`` axis (``blocks/attn/wq`` is (depth, dim, heads,
dh)); the port splits it, one ``Block`` per layer
(``blocks.<i>.attn.wq``). Every other leaf keeps its JAX shape and
layout: ``embed/table`` (vocab, dim), ``pos`` (1, max_len, dim). The
LM's head is tied to ``embed/table`` and has no leaf of its own.

The image-classification zoo and the Progressive GAN's G, D and Gs
(:func:`from_jax_tree`, :func:`to_jax_tree`):
a tree path is the module path (``convs/3/kernel`` is ``convs.3.kernel``,
``layers/0/bias`` is ``layers.0.bias``, ``s1b0/proj_bn/scale`` is
``s1b0.proj_bn.scale``); a list in the JAX tree (``convs``, ``layers``)
is indexed by position (the GAN's ``torgb/0/w``, ``fromrgb/3/b``,
``blocks/1/conv0/w``). A :class:`~rafiki_tpu_torch.models.core.Conv2d`
kernel and a :class:`~rafiki_tpu_torch.models.pggan.EqConv` weight are
HWIO there and OIHW (``channels_last``) here. The BatchNorm
state tree (``<bn>/mean``, ``<bn>/var``) maps to the buffers. Both
directions are exact.

A population's member-stacked trees (:func:`stacked_from_jax_tree`,
:func:`stacked_to_jax_tree`) carry the same layouts with a leading member
axis on every leaf. :func:`jax_layout` says where each parameter sits in
the JAX tree without copying it (int8 serving quantizes in those axes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.models.bert import Bert, BertConfig
from rafiki_tpu_torch.models.core import Conv2d, hwio_to_oihw, oihw_to_hwio
from rafiki_tpu_torch.models.lm import LM, LMConfig
from rafiki_tpu_torch.models.pggan import EqConv
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


#: each conv module's kernel leaf: HWIO in the JAX tree, OIHW here
_KERNEL_LEAF = {Conv2d: "kernel", EqConv: "w"}


def _conv_kernels(model: torch.nn.Module) -> set:
    return {f"{name}.{_KERNEL_LEAF[type(mod)]}" if name
            else _KERNEL_LEAF[type(mod)]
            for name, mod in model.named_modules()
            if type(mod) in _KERNEL_LEAF}


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
        # a copy: the tree must not alias the live parameters
        t = value.detach().to("cpu", torch.float32, copy=True)
        t = oihw_to_hwio(t) if name in convs else t
        (state if name in buffers else params)[
            name.replace(".", SEP)] = t.numpy()
    return (_unflatten_lists(unflatten(params)),
            _unflatten_lists(unflatten(state)))


def jax_layout(model: torch.nn.Module) -> List[Tuple[str, List[str], str]]:
    """Where each of ``model``'s parameters sits in its JAX-layout tree:
    ``(tree path, parameter names, kind)`` a leaf of the tree. ``kind``
    is ``"stack"`` for a transformer family's block leaf, which stacks
    the named per-layer parameters on a new leading axis
    (:func:`from_jax_params`), ``"conv"`` for a kernel that is OIHW here
    and HWIO there (:func:`from_jax_tree`), else ``"plain"``."""
    names = [name for name, _ in model.named_parameters()]
    if not isinstance(model, tuple(FAMILIES.values())):
        convs = _conv_kernels(model)
        return [(name.replace(".", SEP), [name],
                 "conv" if name in convs else "plain") for name in names]
    layout: List[Tuple[str, List[str], str]] = []
    blocks: Dict[str, list] = {}
    for name in names:
        if name.startswith("blocks."):
            _, index, rest = name.split(".", 2)
            path = "blocks" + SEP + rest.replace(".", SEP)
            if path not in blocks:
                blocks[path] = []
                layout.append((path, blocks[path], "stack"))
            blocks[path].append((int(index), name))
        else:
            layout.append((name.replace(".", SEP), [name], "plain"))
    return [(path, [n for _, n in sorted(items)] if kind == "stack"
             else items, kind) for path, items, kind in layout]


def stacked_from_jax_tree(model: torch.nn.Module, params: Dict[str, Any],
                          device=None) -> Dict[str, torch.Tensor]:
    """A member-stacked JAX-layout tree (every leaf with a leading member
    axis, as ``jax.vmap`` and the JAX ``PopulationTrainer`` hold it) as
    ``model``'s parameters stacked the same way, ``{name: (K, ...)}`` f32
    on ``device`` (the default device when None); a conv kernel (K, H,
    W, I, O) becomes (K, O, I, H, W). ``model`` gives the names and may
    be on the ``meta`` device. Names and shapes are checked strictly."""
    dev = default_device(device)
    convs = _conv_kernels(model)
    want = {name: tuple(p.shape) for name, p in model.named_parameters()}
    out = {}
    for path, value in flatten(params).items():
        name = path.replace(SEP, ".")
        t = torch.from_numpy(np.array(value, np.float32))
        if name in convs:
            t = t.permute(0, 4, 3, 1, 2)
        if name not in want or tuple(t.shape[1:]) != want[name]:
            raise ValueError(f"stacked leaf {path} {tuple(t.shape)} does "
                             "not fit the model")
        out[name] = t.contiguous().to(dev)
    if set(out) != set(want):
        raise ValueError(f"stacked tree misses {sorted(set(want) - set(out))}")
    return out


def stacked_to_jax_tree(model: torch.nn.Module,
                        params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`stacked_from_jax_tree`: numpy copies in the
    JAX layout, the member axis leading every leaf."""
    convs = _conv_kernels(model)
    flat = {}
    for name, value in params.items():
        t = value.detach().to("cpu", torch.float32, copy=True)
        if name in convs:
            t = t.permute(0, 3, 4, 2, 1)
        flat[name.replace(".", SEP)] = t.contiguous().numpy()
    return _unflatten_lists(unflatten(flat))
