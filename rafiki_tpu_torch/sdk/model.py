"""The model-template contract.

Counterpart of ``rafiki_tpu/sdk/model.py``: ``BaseModel`` with the methods
a train worker calls (``get_knob_config``, ``train``, ``evaluate``,
``dump_parameters``; ``logger`` and ``checkpoint_path`` are set on the
instance before ``train``), those an inference worker calls
(``load_parameters``, ``warm_up``, ``predict``, ``destroy``), and
``load_model_class``, which imports an uploaded template's bytes and checks
that the class subclasses this package's ``BaseModel``, and
``validate_model_dependencies``, which the admin runs at upload, and
``test_model_class``, the local contract harness (over the port's
advisor, parameter serialization and ensemble). The generation contract:
``GenerationSpec``, the decode methods a ``TEXT_GENERATION`` template
overrides (the ring, the paged pool and the sampled steps) and the
capability oracles the admin and the generation worker consult. The
population hooks, the speculative-decoding methods
(``paged_verify_step``, ``decode_steps_sampled``), the fused-ensemble
hook and dependency provisioning wait (ROADMAP.md).
"""

from __future__ import annotations

import abc
import importlib.util
import inspect
import json
import logging
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.sdk.knob import (
    BaseKnob,
    KnobConfig,
    serialize_knob_config,
    validate_knobs,
)
from rafiki_tpu_torch.sdk.log import ModelLogger, logger as _module_logger


class InvalidModelClassError(Exception):
    pass


#: pip names whose import name differs (``rafiki_tpu/sdk/deps.py``)
IMPORT_ALIASES = {"scikit-learn": "sklearn", "pillow": "PIL",
                  "pyyaml": "yaml", "opencv-python": "cv2"}


class GenerationSpec:
    """Declares that a template serves the ``TEXT_GENERATION`` task:
    KV-cached decode with token-level continuous batching
    (``worker/generation.py``). Set as a class attribute::

        class MyLM(BaseModel):
            generation_spec = GenerationSpec(eos_token_id=0,
                                             max_context=128)

    ``eos_token_id`` ends a sequence the step it is emitted (None: run to
    ``max_tokens``); ``max_context`` is the cache's length a slot: prompt
    and generated tokens must fit, and a sequence reaching it finishes
    with reason ``context``. A template advertising a spec must override
    the three decode methods of :class:`BaseModel` (``init_kv_cache``,
    ``prefill``, ``decode_step``); :func:`generation_capability` refuses
    a spec whose methods are the base stubs, so a half-wired template is
    a typed deploy error, never a mid-serving crash."""

    def __init__(self, eos_token_id: Optional[int] = None,
                 max_context: int = 128):
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.max_context = max(int(max_context), 2)

    def __repr__(self) -> str:
        return (f"GenerationSpec(eos_token_id={self.eos_token_id!r}, "
                f"max_context={self.max_context})")


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

    # -- the generation contract (worker/generation.py drives it) ----------

    #: a :class:`GenerationSpec` advertises TEXT_GENERATION serving
    generation_spec: Optional[GenerationSpec] = None

    def init_kv_cache(self, max_slots: int) -> Any:
        """Allocate a decode cache for ``max_slots`` co-resident sequences;
        called once by the generation worker after ``load_parameters``."""
        raise NotImplementedError

    def prefill(self, cache: Any, slot: int,
                prompt_ids: List[int]) -> Tuple[int, Any]:
        """Ingest a prompt into ``slot``; ``(first_generated_token_id,
        cache)``."""
        raise NotImplementedError

    def decode_step(self, cache: Any, ids: Any, positions: Any
                    ) -> Tuple[Any, Any]:
        """One token for EVERY slot: ``ids``/``positions`` are int arrays
        of length ``max_slots`` (the last token per slot and the cache row
        it lands at; idle slots carry zeros and are ignored).
        ``(next_token_ids, cache)``."""
        raise NotImplementedError

    def init_paged_kv_cache(self, pool_blocks: int,
                            block_tokens: int) -> Any:
        """Allocate a pool of ``pool_blocks`` pages of ``block_tokens`` K/V
        rows. A template that also overrides the paged methods below serves
        under the paged allocator (``worker/kv_paging.py``): prefix cache,
        chunked prefill, preemption."""
        raise NotImplementedError

    def paged_prefill(self, cache: Any, block_table: Any,
                      prompt_ids: List[int], start: int) -> Tuple[int, Any]:
        """Ingest prompt tokens at positions ``start ..
        start + len(prompt_ids) - 1`` of the slot whose pages are
        ``block_table`` (sentinel = pool size for unallocated entries).
        ``(next_token_id, cache)``; the token counts only when the call
        covered the prompt's last position."""
        raise NotImplementedError

    def paged_decode_step(self, cache: Any, ids: Any, positions: Any,
                          block_tables: Any) -> Tuple[Any, Any]:
        """One token for every slot against the pool; ``block_tables`` is
        (max_slots, table_blocks), idle slots all-sentinel."""
        raise NotImplementedError

    def kv_copy_blocks(self, cache: Any, src: Any, dst: Any) -> Any:
        """Copy whole pages ``src[i] -> dst[i]``: the allocator's
        copy-on-write."""
        raise NotImplementedError

    def decode_step_sampled(self, cache: Any, ids: Any, positions: Any,
                            sampling: Any) -> Tuple[Any, Any, Any]:
        """``decode_step`` with a temperature/top-k/top-p draw.
        ``sampling`` holds per-slot arrays ``seed``, ``temperature``,
        ``top_k`` (0 = off) and ``top_p`` (1.0 = off), and a scalar
        ``role``. Every draw must be keyed
        ``fold_in(fold_in(PRNGKey(seed), position), role)``, and
        temperature <= 0 must give the greedy argmax.
        ``(token_ids, probs, cache)``."""
        raise NotImplementedError

    def paged_decode_step_sampled(self, cache: Any, ids: Any,
                                  positions: Any, block_tables: Any,
                                  sampling: Any) -> Tuple[Any, Any, Any]:
        """``paged_decode_step`` with the same draw as
        ``decode_step_sampled``."""
        raise NotImplementedError


_log = logging.getLogger(__name__)

#: the decode methods a generation-capable template must override
GENERATION_METHODS = ("init_kv_cache", "prefill", "decode_step")
#: and those of the paged allocator
GENERATION_PAGED_METHODS = ("init_paged_kv_cache", "paged_prefill",
                            "paged_decode_step", "kv_copy_blocks")

#: the roles of the keyed draws (models/lm.py)
ROLE_TARGET = 0
ROLE_DRAFT = 1
ROLE_ACCEPT = 2


def _overrides(clazz: type, name: str) -> bool:
    return getattr(clazz, name, None) is not getattr(BaseModel, name)


def generation_capability(clazz: type) -> Optional[GenerationSpec]:
    """The template's :class:`GenerationSpec` when it is fully wired (a
    spec and the three decode methods overridden), else None; callers turn
    None into a typed error, there being no path to fall back to."""
    spec = getattr(clazz, "generation_spec", None)
    if spec is None:
        return None
    if not isinstance(spec, GenerationSpec):
        _log.warning("%s.generation_spec is not a GenerationSpec (%s); "
                     "ignoring", clazz.__name__, type(spec).__name__)
        return None
    missing = [m for m in GENERATION_METHODS if not _overrides(clazz, m)]
    if missing:
        _log.warning("%s declares generation_spec but does not override "
                     "%s; template is NOT generation-capable",
                     clazz.__name__, missing)
        return None
    return spec


def paged_generation_capability(clazz: type) -> Optional[GenerationSpec]:
    """The spec when the template also overrides the four paged methods;
    None serves the ring instead (a safe fallback)."""
    spec = generation_capability(clazz)
    if spec is None or not all(_overrides(clazz, m)
                               for m in GENERATION_PAGED_METHODS):
        return None
    return spec


def sampling_capability(clazz: type) -> Optional[GenerationSpec]:
    """The spec when real sampling is wired: ``decode_step_sampled``, and
    ``paged_decode_step_sampled`` too for a paged-capable template. None
    serves greedy only, and a sampled request gets a typed error."""
    spec = generation_capability(clazz)
    if spec is None:
        return None
    needed = ["decode_step_sampled"]
    if paged_generation_capability(clazz) is not None:
        needed.append("paged_decode_step_sampled")
    missing = [m for m in needed if not _overrides(clazz, m)]
    if missing:
        _log.warning("%s does not override %s; template is NOT "
                     "sampling-capable: sampled requests will be refused",
                     clazz.__name__, missing)
        return None
    return spec


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


def test_model_class(
    model_file_path: Optional[str] = None,
    model_class: Optional[str] = None,
    task: Optional[str] = None,
    dependencies: Optional[Dict[str, Optional[str]]] = None,
    train_dataset_uri: Optional[str] = None,
    test_dataset_uri: Optional[str] = None,
    queries: Optional[List[Any]] = None,
    clazz: Optional[type] = None,
    knobs: Optional[Dict[str, Any]] = None,
) -> List[Any]:
    """The local contract harness (``rafiki_tpu/sdk/model.py``): the
    lifecycle a deployed trial runs. Dependency check, knob-config check
    (and its wire format), an advisor proposal (unless ``knobs`` is
    given), train, evaluate (a float score), parameters through bytes,
    a fresh instance, predict (one JSON-able prediction per query) and an
    ensemble of two copies. Returns the predictions. Call with ``clazz=``
    or with ``model_file_path=`` and ``model_class=``; the models run on
    the thread's default device."""
    from rafiki_tpu_torch.advisor.advisor import Advisor
    from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
    from rafiki_tpu_torch.sdk.params import dump_params, load_params

    if clazz is None:
        assert model_file_path is not None and model_class is not None
        with open(model_file_path, "rb") as f:
            clazz = load_model_class(f.read(), model_class)

    missing = validate_model_dependencies(clazz)
    if missing:
        raise InvalidModelClassError(f"Missing dependencies: {missing}")

    knob_config = clazz.get_knob_config()
    for name, knob in knob_config.items():
        if not isinstance(knob, BaseKnob):
            raise InvalidModelClassError(f"Knob {name!r} is not a BaseKnob")
    serialize_knob_config(knob_config)  # must survive the HTTP wire format

    if knobs is None:
        knobs = Advisor(knob_config).propose()
    validate_knobs(knob_config, knobs)
    print(f"[test_model_class] knobs: {knobs}")

    model = clazz(**knobs)
    assert train_dataset_uri is not None and test_dataset_uri is not None
    model.train(train_dataset_uri)
    try:
        score = float(model.evaluate(test_dataset_uri))
    except (TypeError, ValueError):
        raise InvalidModelClassError("evaluate() must return a float score")
    print(f"[test_model_class] score: {score}")

    # parameters through bytes, as the worker and the predictor pass them
    params_bytes = dump_params(model.dump_parameters())
    model.destroy()

    model = clazz(**knobs)
    model.load_parameters(load_params(params_bytes))

    queries = queries if queries is not None else []
    predictions = model.predict(queries)
    if not isinstance(predictions, list) or len(predictions) != len(queries):
        raise InvalidModelClassError(
            "predict() must return one prediction per query")
    try:
        json.dumps(predictions)
    except (TypeError, ValueError) as e:
        raise InvalidModelClassError(
            f"Predictions not JSON-serializable: {e}")

    if queries:
        ensemble_predictions([predictions, predictions], task)

    model.destroy()
    print("[test_model_class] OK")
    return predictions
