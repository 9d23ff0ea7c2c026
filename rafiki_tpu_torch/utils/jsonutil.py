"""One JSON wire convention for what crosses a process boundary (the shm
broker's legacy JSON messages, the binary frames' headers): numpy arrays
and scalars serialize through ``tolist()``/``item()`` at any nesting
depth; anything else that is not JSON raises TypeError, so nothing is
corrupted quietly.

Own copy of ``rafiki_tpu/utils/jsonutil.py``; the original names no JAX
type, so the copy is the same code.
"""

from __future__ import annotations

import json
from typing import Any


def json_default(o: Any):
    if hasattr(o, "tolist"):
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(
        f"{type(o).__name__} is not JSON-serializable on the wire")


def dumps(obj: Any) -> str:
    return json.dumps(obj, default=json_default)
