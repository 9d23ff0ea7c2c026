"""The model-template contract.

Counterpart of ``rafiki_tpu/sdk/model.py``: ``BaseModel`` with the methods
a train worker calls (``get_knob_config``, ``train``, ``evaluate``,
``dump_parameters``; ``logger`` and ``checkpoint_path`` are set on the
instance before ``train``), those an inference worker calls
(``load_parameters``, ``warm_up``, ``predict``, ``destroy``), and
``load_model_class``, which imports an uploaded template's bytes and checks
that the class subclasses this package's ``BaseModel``, and
``validate_model_dependencies``, which the admin runs at upload. The
population, generation and ensemble hooks, dependency provisioning and
the ``test_model_class`` harness wait (ROADMAP.md).
"""

from __future__ import annotations

import abc
import importlib.util
import inspect
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.sdk.knob import KnobConfig
from rafiki_tpu_torch.sdk.log import ModelLogger, logger as _module_logger


class InvalidModelClassError(Exception):
    pass


#: pip names whose import name differs (``rafiki_tpu/sdk/deps.py``)
IMPORT_ALIASES = {"scikit-learn": "sklearn", "pillow": "PIL",
                  "pyyaml": "yaml", "opencv-python": "cv2"}


class BaseModel(abc.ABC):
    """What a template implements. Instantiated once per trial as
    ``Model(**knobs)`` with a knob assignment proposed by the advisor."""

    #: declared dependencies: {package_name: version_spec_or_None}
    dependencies: Dict[str, Optional[str]] = {}

    def __init__(self, **knobs: Any):
        self._knobs = knobs
        self.logger: ModelLogger = _module_logger
        #: set by the train worker before ``train()``: a per-trial file path
        #: templates MAY hand to ``DataParallelTrainer.fit(checkpoint_path=
        #: ...)`` so a re-run trial resumes from its last epoch. None when
        #: run outside a worker.
        self.checkpoint_path: Optional[str] = None

    @staticmethod
    @abc.abstractmethod
    def get_knob_config() -> KnobConfig:
        """The tunable hyperparameter space for this template."""

    @abc.abstractmethod
    def train(self, dataset_uri: str) -> None:
        """Train on the dataset at ``dataset_uri``."""

    @abc.abstractmethod
    def evaluate(self, dataset_uri: str) -> float:
        """Return a scalar score (higher is better) on the dataset."""

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


def validate_model_dependencies(clazz: type) -> List[str]:
    """The declared dependencies of ``clazz`` that do not import here."""
    deps = getattr(clazz, "dependencies", {}) or {}
    return [dep for dep in deps if importlib.util.find_spec(
        IMPORT_ALIASES.get(dep.lower(), dep.replace("-", "_"))) is None]
