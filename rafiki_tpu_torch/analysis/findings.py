"""The template verifier's findings and report.

Own copy of ``rafiki_tpu/analysis/findings.py``, with the codes of the
template head. A *finding* is one rule violation at one source location;
a *VerificationReport* is the verifier's result for one uploaded model
file, JSON-able both ways because it is persisted on the model row
(``model.verification``) and shipped over HTTP (``POST /models/verify``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch.sdk.model import InvalidModelClassError

#: severities — ``error`` findings reject an upload at
#: RAFIKI_VERIFY_TEMPLATES=enforce; ``warn`` findings are surfaced but
#: never block (heuristic detectors stay warnings so a false positive
#: can never lock a working template out of the platform)
ERROR = "error"
WARN = "warn"

#: finding-code catalog: TPL (structural contract), POP (PopulationSpec
#: consistency), GEN (GenerationSpec consistency), JAX (tracing pitfalls,
#: kept so both packages report one template alike), SBX (sandbox policy)
CODES: Dict[str, str] = {
    "TPL001": "required BaseModel method missing",
    "TPL002": "knob config is not statically evaluable",
    "TPL003": "import of an undeclared non-platform dependency",
    "TPL004": "model class missing or not a BaseModel subclass",
    "TPL005": "template does not parse",
    "TPL006": "get_knob_config must be a @staticmethod",
    "TPL007": "dependencies attribute is not a literal dict",
    "SBX001": "sandbox-forbidden import",
    "POP001": "dynamic knob not present in the knob config",
    "POP002": "population_spec declared but population methods missing",
    "POP003": "Python branching on a dynamic knob in the train path",
    "POP004": "population_spec is not statically parseable",
    "GEN001": "generation_spec declared but decode methods missing",
    "GEN002": "generation decode method has an inconsistent signature",
    "GEN003": "generation_spec is not statically parseable",
    "JAX001": "host sync (.item()/float()/np.asarray) on a traced value",
    "JAX002": "legacy global numpy.random API (thread PRNG keys instead)",
    "JAX003": "mutation of self state inside a jit/vmap-traced function",
    "JAX004": "recompile risk: jit over loop-varying or per-request values",
}


@dataclasses.dataclass
class Finding:
    code: str
    message: str
    severity: str = ERROR
    file: str = "<uploaded>"
    line: int = 0
    col: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Finding":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{loc}: {self.severity} {self.code}: {self.message}"


class VerificationReport:
    """The template verifier's verdict for one model source file."""

    def __init__(self, class_name: Optional[str] = None,
                 findings: Optional[List[Finding]] = None,
                 capabilities: Optional[Dict[str, Any]] = None):
        self.class_name = class_name
        self.findings: List[Finding] = list(findings or [])
        #: statically-derived capability verdicts — the single oracle
        #: replacing ad-hoc source sniffs (doctor's vmap probe):
        #: {"population": bool, "population_spec": {...}|None}
        self.capabilities: Dict[str, Any] = dict(capabilities or {})

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        """True when nothing blocks an enforce-mode upload."""
        return not self.errors

    def add(self, code: str, message: str, severity: str = ERROR,
            file: str = "<uploaded>", line: int = 0, col: int = 0) -> None:
        self.findings.append(Finding(code, message, severity, file, line, col))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "class_name": self.class_name,
            "capabilities": self.capabilities,
            "findings": [f.to_dict() for f in self.findings],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VerificationReport":
        return cls(
            class_name=d.get("class_name"),
            findings=[Finding.from_dict(f) for f in d.get("findings", [])],
            capabilities=d.get("capabilities") or {},
        )

    def summary(self) -> str:
        if not self.findings:
            return "clean"
        return (f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")


class ModelVerificationError(InvalidModelClassError):
    """An enforce-mode upload was rejected by the template verifier.

    Subclasses InvalidModelClassError so every existing HTTP door maps it
    to 400 with zero new wiring; carries the full report for clients that
    want the finding list (``Client.verify_model`` is the dry-run path)."""

    def __init__(self, report: VerificationReport):
        self.report = report
        lines = "; ".join(str(f) for f in report.errors[:5])
        more = len(report.errors) - 5
        if more > 0:
            lines += f" (+{more} more)"
        super().__init__(
            f"model template failed static verification "
            f"({report.summary()}): {lines}")
