"""Static analysis of uploaded model templates (no uploaded code runs).

Own copy of the template-verifier head of ``rafiki_tpu/analysis/``:
:func:`verify_template_bytes` runs the pass pipeline of
:mod:`.template` over an upload. ``Admin.create_model`` runs it under
``RAFIKI_VERIFY_TEMPLATES=enforce|warn|off`` (:func:`verify_mode`) and
``POST /models/verify`` as a dry run. The JAX package's framework
self-lint and concurrency analyzer check that package's own source and
are not on the upload path (ROADMAP.md).
"""

import os

from rafiki_tpu_torch.analysis.findings import (
    CODES,
    ERROR,
    WARN,
    Finding,
    ModelVerificationError,
    VerificationReport,
)
from rafiki_tpu_torch.analysis.template import (
    verify_template_bytes,
    verify_template_source,
)

__all__ = [
    "CODES",
    "ERROR",
    "WARN",
    "Finding",
    "ModelVerificationError",
    "VerificationReport",
    "verify_template_bytes",
    "verify_template_source",
    "verify_mode",
]


def verify_mode() -> str:
    """The upload-verification mode: ``enforce`` (error findings reject
    the upload with a typed ModelVerificationError), ``warn`` (findings
    are logged and persisted on the model row, the upload proceeds) or
    ``off``. Unrecognized values fall back to ``enforce``: a typo must
    not disable the check."""
    mode = os.environ.get("RAFIKI_VERIFY_TEMPLATES", "enforce").lower()
    return mode if mode in ("enforce", "warn", "off") else "enforce"
