"""The port's template verifier against the JAX package's.

Both verifiers run over every template in the repo: the JAX examples,
the test fixtures (the bad-template corpus included), the port's
``TorchViT`` and the tiny templates that the port's tests upload. They
must give the same findings (code, severity, line) and capabilities.
The one difference allowed is named here: each package treats its own
platform modules as implicit, so an import of ``torch`` or
``rafiki_tpu_torch`` is an undeclared dependency (TPL003) for the JAX
verifier, and an import of ``jax``, ``jaxlib``, ``optax`` or
``rafiki_tpu`` is one for the port's.
"""

import ast
import re
from pathlib import Path

import pytest

from rafiki_tpu import analysis as jax_analysis
from rafiki_tpu_torch import analysis
from rafiki_tpu_torch.analysis import astutil

ROOT = Path(__file__).resolve().parents[1]
#: modules only one package provides without a declaration
IMPLICIT_ONLY = {"jax": {"rafiki_tpu", "jax", "jaxlib", "optax"},
                 "torch": {"rafiki_tpu_torch", "torch"}}
_TPL003_MODULE = re.compile(r"^import '([^']+)'")


def _test_file_templates():
    """Module-level template constants of ``tests/test_torch_*.py``: bytes
    literals, and sums of earlier ones with a literal, whose source
    defines a class."""
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        consts = {}
        for node in ast.parse(path.read_text()).body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            value = node.value
            if isinstance(value, ast.BinOp) and isinstance(value.op, ast.Add) \
                    and isinstance(value.left, ast.Name) \
                    and value.left.id in consts:
                try:
                    value = consts[value.left.id] + ast.literal_eval(
                        value.right)
                except (ValueError, TypeError):
                    continue
            else:
                try:
                    value = ast.literal_eval(value)
                except ValueError:
                    continue
            if isinstance(value, bytes):
                consts[node.targets[0].id] = value
        for name, source in consts.items():
            if b"class " in source:
                yield f"{path.name}:{name}", source


def _templates():
    paths = sorted((ROOT / "examples" / "models").rglob("*.py")) + sorted(
        (ROOT / "tests" / "fixtures").glob("*.py")) + sorted(
        (ROOT / "tests" / "fixtures" / "bad_templates").glob("*.py")) + [
        ROOT / "rafiki_tpu_torch" / "templates" / "torch_vit.py"]
    cases = [(p.relative_to(ROOT).as_posix(), p.read_bytes()) for p in paths]
    return cases + list(_test_file_templates())


TEMPLATES = _templates()


def _split(report, package):
    """(findings both packages must share, the implicit-module ones)."""
    shared, implicit = [], []
    for f in report.findings:
        m = _TPL003_MODULE.match(f.message) if f.code == "TPL003" else None
        if m and m.group(1) in IMPLICIT_ONLY[
                "torch" if package == "jax" else "jax"]:
            implicit.append(m.group(1))
        else:
            shared.append((f.code, f.severity, f.line))
    return shared, implicit


def test_the_corpus_is_found():
    names = [n for n, _ in TEMPLATES]
    assert len(names) >= 30
    assert "rafiki_tpu_torch/templates/torch_vit.py" in names
    assert "tests/fixtures/fake_model.py" in names
    assert any(n.startswith("test_torch_train_job.py:") for n in names)
    assert any(n.startswith("test_torch_stack.py:") for n in names)


@pytest.mark.parametrize("name,source", TEMPLATES,
                         ids=[n for n, _ in TEMPLATES])
def test_findings_match_the_jax_verifier(name, source):
    theirs = jax_analysis.verify_template_bytes(source)
    ours = analysis.verify_template_bytes(source)
    shared_j, implicit_j = _split(theirs, "jax")
    shared_t, implicit_t = _split(ours, "torch")
    assert shared_t == shared_j
    assert ours.class_name == theirs.class_name
    assert ours.capabilities == theirs.capabilities
    # the excused findings are imports of the other platform, each once
    # (a template may declare them as dependencies, and then has none)
    try:
        imports = set(astutil.imported_top_modules(ast.parse(source)))
    except SyntaxError:
        imports = set()
    for implicit, other in ((implicit_j, "torch"), (implicit_t, "jax")):
        assert len(set(implicit)) == len(implicit)
        assert set(implicit) <= imports & IMPLICIT_ONLY[other]


def test_torch_vit_passes_enforce():
    source = (ROOT / "rafiki_tpu_torch" / "templates"
              / "torch_vit.py").read_bytes()
    report = analysis.verify_template_bytes(source, "TorchViT")
    assert report.ok and report.errors == []
    assert report.class_name == "TorchViT"
    # the JAX verifier refuses it only for the port's platform modules
    theirs = jax_analysis.verify_template_bytes(source, "TorchViT")
    assert {f.code for f in theirs.errors} == {"TPL003"}


@pytest.mark.parametrize("mode,expect", [
    (None, "enforce"), ("warn", "warn"), ("OFF", "off"),
    ("enforse", "enforce")])
def test_verify_mode(monkeypatch, mode, expect):
    if mode is None:
        monkeypatch.delenv("RAFIKI_VERIFY_TEMPLATES", raising=False)
    else:
        monkeypatch.setenv("RAFIKI_VERIFY_TEMPLATES", mode)
    assert analysis.verify_mode() == expect == jax_analysis.verify_mode()


def test_report_round_trips_and_refuses():
    report = analysis.verify_template_bytes(b"import subprocess\n")
    assert not report.ok
    again = analysis.VerificationReport.from_dict(report.to_dict())
    assert again.to_dict() == report.to_dict()
    err = analysis.ModelVerificationError(report)
    assert "SBX001" in str(err) and err.report is report
