"""The model-template contract, serving half.

Counterpart of ``rafiki_tpu/sdk/model.py``: ``BaseModel`` with the methods
an inference worker calls (``predict``, ``load_parameters``,
``dump_parameters``, ``warm_up``, ``destroy``) and ``load_model_class``,
which imports an uploaded template's bytes and checks that the class
subclasses this package's ``BaseModel``. ``train``/``evaluate`` and the
knob classes come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import abc
import importlib.util
import inspect
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional


class InvalidModelClassError(Exception):
    pass


class BaseModel(abc.ABC):
    """What a served template implements. Instantiated once per trial as
    ``Model(**knobs)``."""

    def __init__(self, **knobs: Any):
        self._knobs = knobs

    @staticmethod
    @abc.abstractmethod
    def get_knob_config() -> Dict[str, Any]:
        """The template's knobs (fixed values in this slice)."""

    @abc.abstractmethod
    def predict(self, queries: List[Any]) -> List[Any]:
        """Return one JSON-able prediction per query."""

    @abc.abstractmethod
    def dump_parameters(self) -> Dict[str, Any]:
        """Return the parameter tree (nested dicts of arrays)."""

    @abc.abstractmethod
    def load_parameters(self, params: Dict[str, Any]) -> None:
        """Restore parameters produced by ``dump_parameters``."""

    def warm_up(self) -> None:
        """Called once by the inference worker after ``load_parameters`` and
        before the service reports ready: run ``predict`` at every batch
        bucket serving will use, so kernels are built and loaded before
        traffic arrives. Default: no-op."""

    def destroy(self) -> None:
        """Release resources (default: no-op)."""


def load_model_class(model_bytes: bytes, class_name: str,
                     temp_dir: Optional[str] = None) -> type:
    """Import an uploaded template's ``.py`` bytes and return its class."""
    tmp = tempfile.NamedTemporaryFile("wb", suffix=".py", dir=temp_dir,
                                      delete=False)
    try:
        tmp.write(model_bytes)
        tmp.close()
        mod_name = f"rafiki_torch_model_{os.path.basename(tmp.name)[:-3]}"
        spec = importlib.util.spec_from_file_location(mod_name, tmp.name)
        if spec is None or spec.loader is None:
            raise InvalidModelClassError("uploaded model file cannot be "
                                         "imported")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
        clazz = getattr(module, class_name, None)
        if clazz is None or not inspect.isclass(clazz):
            raise InvalidModelClassError(
                f"Class {class_name!r} not found in uploaded model file")
        if not issubclass(clazz, BaseModel):
            raise InvalidModelClassError(
                f"{class_name} must subclass rafiki_tpu_torch BaseModel")
        return clazz
    finally:
        try:
            os.unlink(tmp.name)
        except OSError:
            pass
