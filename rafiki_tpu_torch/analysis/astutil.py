"""AST plumbing of the template verifier.

Own copy of the parts of ``rafiki_tpu/analysis/astutil.py`` that
:mod:`.template` uses. Everything here is syntax: no uploaded code is
imported or run."""

from __future__ import annotations

import ast
import sys
from typing import Dict, Iterable, List, Optional, Set

#: stdlib top-level module names (py3.10+); the fallback set keeps the
#: analyzer usable on older interpreters without claiming completeness
STDLIB_MODULES: Set[str] = set(getattr(sys, "stdlib_module_names", ()) or (
    "abc os sys re json math time random types typing itertools functools "
    "collections dataclasses tempfile threading logging io struct base64 "
    "hashlib pickle copy string textwrap traceback inspect importlib "
    "contextlib warnings enum uuid datetime pathlib queue".split()))


def parse(source: str, filename: str = "<uploaded>") -> ast.Module:
    """ast.parse that callers wrap for the typed TPL005 finding."""
    return ast.parse(source, filename=filename)


def terminal_name(node: ast.AST) -> Optional[str]:
    """The final identifier of a Name/Attribute chain: ``jax.numpy.sum``
    -> ``sum``; ``jit`` -> ``jit``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """Full dotted chain for Name/Attribute, else None:
    ``np.random.seed`` -> "np.random.seed"."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """First identifier of a Name/Attribute chain (``np`` of
    ``np.random.seed``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def is_constant(node: ast.AST) -> bool:
    """A value the platform can evaluate without running user code:
    constants, +-constants, and containers of such."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)):
        return is_constant(node.operand)
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return all(is_constant(e) for e in node.elts)
    if isinstance(node, ast.Dict):
        return all(k is not None and is_constant(k) for k in node.keys) and \
            all(is_constant(v) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow)):
        return is_constant(node.left) and is_constant(node.right)
    return False


_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
           ast.Pow: lambda a, b: a ** b}


def literal_value(node: ast.AST):
    """Evaluate exactly what :func:`is_constant` accepts — including the
    arithmetic BinOps ast.literal_eval refuses (``2 ** 10``); raises
    ValueError when not constant (callers treat that as non-literal)."""
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        try:
            return _BINOPS[type(node.op)](literal_value(node.left),
                                          literal_value(node.right))
        except (TypeError, ZeroDivisionError) as e:
            raise ValueError(f"unevaluable constant expression: {e}")
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        values = [literal_value(e) for e in node.elts]
        return {ast.List: list, ast.Tuple: tuple,
                ast.Set: set}[type(node)](values)
    if isinstance(node, ast.Dict):
        return {literal_value(k): literal_value(v)
                for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def walk_no_nested_functions(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function/class
    definitions — their bodies are separate analysis scopes."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _is_main_guard(node: ast.AST) -> bool:
    """``if __name__ == "__main__":`` — the local dev harness block;
    nothing under it runs in a worker."""
    if not isinstance(node, ast.If) or not isinstance(node.test,
                                                     ast.Compare):
        return False
    parts = [node.test.left] + list(node.test.comparators)
    names = {p.id for p in parts if isinstance(p, ast.Name)}
    consts = {p.value for p in parts if isinstance(p, ast.Constant)}
    return "__name__" in names and "__main__" in consts


def _catches_import_error(node: ast.AST) -> bool:
    """A Try whose handlers catch ImportError/ModuleNotFoundError — the
    optional-dependency idiom; imports under it degrade gracefully."""
    if not isinstance(node, ast.Try):
        return False
    for handler in node.handlers:
        if handler.type is None:
            return True
        types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
            else [handler.type]
        if any(terminal_name(t) in ("ImportError", "ModuleNotFoundError",
                                    "Exception") for t in types):
            return True
    return False


def imported_top_modules(tree: ast.Module,
                         include_guarded: bool = False) -> Dict[str, int]:
    """{top-level module name: first lineno} over every import the
    WORKER would execute — including function-local imports, but not
    the ``if __name__ == "__main__":`` dev-harness block and not
    imports inside a try/except-ImportError optional-dependency
    fallback. ``include_guarded=True`` keeps both (the sandbox-policy
    pass must see imports a hostile template hides behind a guard)."""
    out: Dict[str, int] = {}
    stack: List[ast.AST] = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if not include_guarded and (_is_main_guard(node)
                                    or _catches_import_error(node)):
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.setdefault(alias.name.split(".")[0], node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.setdefault(node.module.split(".")[0], node.lineno)
        stack.extend(ast.iter_child_nodes(node))
    return out


def class_map(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def is_model_subclass(cls: ast.ClassDef,
                      classes: Dict[str, ast.ClassDef]) -> bool:
    """Does ``cls`` descend (within this file) from a base whose terminal
    name is BaseModel? Covers ``BaseModel``, ``model.BaseModel``, and
    local intermediate bases."""
    seen: Set[str] = set()
    stack = [cls]
    while stack:
        c = stack.pop()
        if c.name in seen:
            continue
        seen.add(c.name)
        for base in c.bases:
            name = terminal_name(base)
            if name == "BaseModel":
                return True
            if name in classes:
                stack.append(classes[name])
    return False


def own_and_inherited_methods(
        cls: ast.ClassDef, classes: Dict[str, ast.ClassDef]
) -> Dict[str, ast.FunctionDef]:
    """Method name -> FunctionDef, following bases defined in the same
    file (nearest definition wins, like the MRO would)."""
    out: Dict[str, ast.FunctionDef] = {}
    seen: Set[str] = set()
    stack = [cls]
    order: List[ast.ClassDef] = []
    while stack:
        c = stack.pop(0)
        if c.name in seen:
            continue
        seen.add(c.name)
        order.append(c)
        for base in c.bases:
            name = terminal_name(base)
            if name in classes:
                stack.append(classes[name])
    for c in order:
        for node in c.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.setdefault(node.name, node)
    return out


def class_attr_assign(
        cls: ast.ClassDef, classes: Dict[str, ast.ClassDef], attr: str
) -> Optional[ast.AST]:
    """The value expression of a class-level ``attr = ...`` assignment,
    following same-file bases (nearest wins)."""
    seen: Set[str] = set()
    stack = [cls]
    while stack:
        c = stack.pop(0)
        if c.name in seen:
            continue
        seen.add(c.name)
        for node in c.body:
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == attr:
                    return node.value
        for base in c.bases:
            name = terminal_name(base)
            if name in classes:
                stack.append(classes[name])
    return None


def contains(node: ast.AST, predicate) -> Optional[ast.AST]:
    """First descendant (or the node itself) matching ``predicate``."""
    for n in ast.walk(node):
        if predicate(n):
            return n
    return None
