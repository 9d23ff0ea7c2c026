"""Model parameter serialization: nested dict of arrays <-> bytes.

The port's artifact is an ``np.savez`` archive whose keys are the tree's
paths joined by ``/`` (``blocks/attn/wq``), read back with
``allow_pickle=False``: loading runs no code, and it needs neither flax
nor msgpack. (The JAX package writes msgpack; reading those artifacts
comes with the control-plane slice, ROADMAP.md.)
"""

from __future__ import annotations

import io
from typing import Any, Dict

import numpy as np
import torch

SEP = "/"


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` with numpy leaves."""
    flat = {}
    for key, value in tree.items():
        if not isinstance(key, str) or not key or SEP in key:
            raise ValueError(f"parameter key {key!r} must be a non-empty "
                             f"string without {SEP!r}")
        path = prefix + key
        if isinstance(value, dict):
            flat.update(flatten(value, path + SEP))
        elif isinstance(value, torch.Tensor):
            flat[path] = value.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def dump_params(params: Dict[str, Any]) -> bytes:
    """Serialize a parameter tree (nested dicts of arrays) to npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, **flatten(params))
    return buf.getvalue()


def load_params(data: bytes) -> Dict[str, Any]:
    """Deserialize npz bytes back into a tree of numpy arrays."""
    with np.load(io.BytesIO(data), allow_pickle=False) as archive:
        return unflatten({k: archive[k] for k in archive.files})
