"""Typed hyperparameter ("knob") space.

Own copy of ``rafiki_tpu/sdk/knob.py`` (numpy only; the port imports
nothing of ``rafiki_tpu``), held against it by
``tests/test_torch_train.py``: CategoricalKnob, FixedKnob, IntegerKnob,
FloatKnob (optionally log-scaled), each encoding itself into the unit
cube the advisor optimizes over, and JSON (de)serialization of knob
configs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np


class BaseKnob:
    """A single tunable hyperparameter."""

    #: number of unit-cube dimensions this knob occupies
    dims: int = 1

    def sample(self, rng: np.random.Generator) -> Any:
        return self.from_unit(rng.random(self.dims))

    def to_unit(self, value: Any) -> np.ndarray:
        raise NotImplementedError

    def from_unit(self, u: np.ndarray) -> Any:
        raise NotImplementedError

    def validate(self, value: Any) -> bool:
        raise NotImplementedError

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_json()})"

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.to_json() == other.to_json()  # type: ignore[union-attr]


class FixedKnob(BaseKnob):
    """A knob pinned to one value (not tuned)."""

    dims = 0

    def __init__(self, value: Any):
        self.value = value

    def to_unit(self, value: Any) -> np.ndarray:
        return np.zeros(0)

    def from_unit(self, u: np.ndarray) -> Any:
        return self.value

    def validate(self, value: Any) -> bool:
        return value == self.value

    def to_json(self) -> Dict[str, Any]:
        return {"type": "fixed", "value": self.value}


class CategoricalKnob(BaseKnob):
    """A knob over a finite unordered set of values (str/int/float/bool)."""

    def __init__(self, values: Sequence[Any]):
        if len(values) == 0:
            raise ValueError("CategoricalKnob needs at least one value")
        self.values: List[Any] = list(values)

    dims = 1

    def to_unit(self, value: Any) -> np.ndarray:
        idx = self.values.index(value)
        # midpoint of the bucket, so from_unit(to_unit(v)) == v
        return np.array([(idx + 0.5) / len(self.values)])

    def from_unit(self, u: np.ndarray) -> Any:
        idx = min(int(float(u[0]) * len(self.values)), len(self.values) - 1)
        return self.values[idx]

    def validate(self, value: Any) -> bool:
        return value in self.values

    def to_json(self) -> Dict[str, Any]:
        return {"type": "categorical", "values": self.values}


def _range_to_unit(v: float, lo: float, hi: float, is_exp: bool) -> float:
    if is_exp:
        llo, lhi = math.log(lo), math.log(hi)
        x = (math.log(v) - llo) / (lhi - llo) if lhi > llo else 0.0
    else:
        x = (v - lo) / (hi - lo) if hi > lo else 0.0
    return min(max(x, 0.0), 1.0)


def _unit_to_range(x: float, lo: float, hi: float, is_exp: bool) -> float:
    if is_exp:
        llo, lhi = math.log(lo), math.log(hi)
        v = math.exp(llo + x * (lhi - llo))
    else:
        v = lo + x * (hi - lo)
    # exp(log(lo)) can round a hair OUTSIDE [lo, hi]; a decoded value the
    # knob's own validate() rejects would error a trial on a perfectly
    # legitimate advisor proposal
    return min(max(v, lo), hi)


class _NumericKnob(BaseKnob):
    """Shared min/max/log-scale machinery for Integer/Float knobs."""

    _json_type: str

    def __init__(self, value_min, value_max, is_exp: bool = False):
        if value_max < value_min:
            raise ValueError("value_max < value_min")
        if is_exp and value_min <= 0:
            raise ValueError("log-scale knob needs value_min > 0")
        self.value_min = value_min
        self.value_max = value_max
        self.is_exp = bool(is_exp)

    def to_unit(self, value: Any) -> np.ndarray:
        return np.array(
            [_range_to_unit(float(value), self.value_min, self.value_max, self.is_exp)]
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "type": self._json_type,
            "value_min": self.value_min,
            "value_max": self.value_max,
            "is_exp": self.is_exp,
        }


class IntegerKnob(_NumericKnob):
    """An integer knob in [value_min, value_max], optionally log-scaled."""

    _json_type = "integer"

    def __init__(self, value_min: int, value_max: int, is_exp: bool = False):
        super().__init__(int(value_min), int(value_max), is_exp)

    def from_unit(self, u: np.ndarray) -> int:
        v = _unit_to_range(float(u[0]), self.value_min, self.value_max, self.is_exp)
        return int(min(max(round(v), self.value_min), self.value_max))

    def validate(self, value: Any) -> bool:
        return (
            isinstance(value, (int, np.integer))
            and self.value_min <= value <= self.value_max
        )


class FloatKnob(_NumericKnob):
    """A float knob in [value_min, value_max], optionally log-scaled
    (``is_exp=True``, e.g. learning rates; reference rafiki/model/knob.py)."""

    _json_type = "float"

    def __init__(self, value_min: float, value_max: float, is_exp: bool = False):
        super().__init__(float(value_min), float(value_max), is_exp)

    def from_unit(self, u: np.ndarray) -> float:
        return float(
            _unit_to_range(float(u[0]), self.value_min, self.value_max, self.is_exp)
        )

    def validate(self, value: Any) -> bool:
        return (
            isinstance(value, (float, int, np.floating, np.integer))
            and self.value_min <= float(value) <= self.value_max + 1e-12
        )


_KNOB_TYPES = {
    "fixed": lambda j: FixedKnob(j["value"]),
    "categorical": lambda j: CategoricalKnob(j["values"]),
    "integer": lambda j: IntegerKnob(j["value_min"], j["value_max"], j.get("is_exp", False)),
    "float": lambda j: FloatKnob(j["value_min"], j["value_max"], j.get("is_exp", False)),
}

KnobConfig = Dict[str, BaseKnob]


def serialize_knob_config(knob_config: KnobConfig) -> Dict[str, Any]:
    """Knob config -> JSON-able dict (reference rafiki/model/knob.py:186-190)."""
    return {name: knob.to_json() for name, knob in knob_config.items()}


def deserialize_knob_config(config_json: Dict[str, Any]) -> KnobConfig:
    """JSON dict -> knob config (reference rafiki/model/knob.py:192-198)."""
    out: KnobConfig = {}
    for name, j in config_json.items():
        ktype = j.get("type")
        if ktype not in _KNOB_TYPES:
            raise ValueError(f"Unknown knob type: {ktype!r}")
        out[name] = _KNOB_TYPES[ktype](j)
    return out


def knob_config_dims(knob_config: KnobConfig) -> int:
    """Total unit-cube dimensionality of a knob config."""
    return sum(k.dims for k in knob_config.values())


def knobs_to_unit(knob_config: KnobConfig, knobs: Dict[str, Any]) -> np.ndarray:
    """Encode a concrete knob assignment into [0,1]^d (stable name order)."""
    parts = [knob_config[name].to_unit(knobs[name]) for name in sorted(knob_config)]
    return np.concatenate(parts) if parts else np.zeros(0)


def knobs_from_unit(knob_config: KnobConfig, u: np.ndarray) -> Dict[str, Any]:
    """Decode a point in [0,1]^d into a concrete knob assignment."""
    out: Dict[str, Any] = {}
    i = 0
    for name in sorted(knob_config):
        knob = knob_config[name]
        out[name] = knob.from_unit(u[i : i + knob.dims])
        i += knob.dims
    return out


def validate_knobs(knob_config: KnobConfig, knobs: Dict[str, Any]) -> None:
    """Raise ValueError if `knobs` doesn't satisfy `knob_config`."""
    missing = set(knob_config) - set(knobs)
    extra = set(knobs) - set(knob_config)
    if missing or extra:
        raise ValueError(f"Knob name mismatch: missing={missing}, extra={extra}")
    for name, knob in knob_config.items():
        if not knob.validate(knobs[name]):
            raise ValueError(f"Invalid value for knob {name!r}: {knobs[name]!r}")
