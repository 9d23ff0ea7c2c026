"""Model parameter serialization: nested dict of arrays <-> bytes.

The port's artifact is an ``np.savez`` archive whose keys are the tree's
paths joined by ``/`` (``blocks/attn/wq``), read back with
``allow_pickle=False``: loading runs no code, and it needs neither flax
nor msgpack. (The JAX package writes msgpack; reading those artifacts
comes with the control-plane slice, ROADMAP.md.)

A leaf that is not an array or a tensor (``None``, a number, a string, a
list of them: what the numpy templates and the zoo's ``num_classes`` or
``depth`` hand over) is stored as its JSON text and its path listed under
:data:`JSON_LEAVES`; a list of subtrees or arrays (the JAX layout's
``layers`` and ``convs``) is stored by index (``layers/0/kernel``) and its
path listed under :data:`LISTS`. Both come back as they went in, as the
JAX package's msgpack gives them back.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SEP = "/"
#: the archive entries listing the paths of JSON-encoded leaves and of
#: lists stored by index
JSON_LEAVES = "__json_leaves__"
LISTS = "__lists__"


def _is_node_list(value: Any) -> bool:
    """A list of subtrees or arrays (not a JSON leaf)."""
    return isinstance(value, (list, tuple)) and any(
        isinstance(v, (dict, list, tuple, np.ndarray, torch.Tensor))
        for v in value)


def _flatten_raw(tree: Dict[str, Any], prefix: str = "",
                 lists: Optional[List[str]] = None) -> Dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``, leaves untouched; a list of
    subtrees is indexed (``a/0/b``) and its path appended to ``lists``."""
    flat = {}
    for key, value in tree.items():
        if not isinstance(key, str) or not key or SEP in key:
            raise ValueError(f"parameter key {key!r} must be a non-empty "
                             f"string without {SEP!r}")
        if _is_node_list(value):
            if lists is not None:
                lists.append(prefix + key)
            value = {str(i): v for i, v in enumerate(value)}
        if isinstance(value, dict):
            flat.update(_flatten_raw(value, prefix + key + SEP, lists))
        else:
            flat[prefix + key] = value
    return flat


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` with numpy leaves."""
    return {k: _to_numpy(v) for k, v in _flatten_raw(tree).items()}


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _is_json_leaf(value: Any) -> bool:
    return value is None or isinstance(value, (bool, int, float, str, list,
                                               tuple))


def dump_params(params: Dict[str, Any]) -> bytes:
    """Serialize a parameter tree (nested dicts of arrays, and JSON-able
    Python leaves) to npz bytes."""
    flat, json_paths, lists = {}, [], []
    for path, value in _flatten_raw(params, lists=lists).items():
        if _is_json_leaf(value):
            flat[path] = np.asarray(json.dumps(value))
            json_paths.append(path)
        else:
            flat[path] = _to_numpy(value)
    for name, paths in ((JSON_LEAVES, json_paths), (LISTS, lists)):
        if name in flat:
            raise ValueError(f"parameter key {name!r} is reserved")
        if paths:
            flat[name] = np.asarray(paths)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def load_params(data: bytes) -> Dict[str, Any]:
    """Deserialize npz bytes back into a tree of numpy arrays (and the
    Python leaves stored as JSON)."""
    with np.load(io.BytesIO(data), allow_pickle=False) as archive:
        flat = {k: archive[k] for k in archive.files}
    lists = flat.pop(LISTS, np.asarray([], str)).tolist()
    for path in flat.pop(JSON_LEAVES, np.asarray([], str)).tolist():
        flat[path] = json.loads(str(flat[path]))
    tree = unflatten(flat)
    # the deepest first, so an outer list sees its items as lists already
    for path in sorted(lists, key=lambda p: -p.count(SEP)):
        *parents, leaf = path.split(SEP)
        node = tree
        for p in parents:
            node = node[p]
        items = node.get(leaf, {})
        node[leaf] = [items[str(i)] for i in range(len(items))]
    return tree
