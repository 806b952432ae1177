"""Lint rules: the serving invariants of the port, as AST passes over torch
code (the reference's ``repro/analysis/rules`` aimed at torch idiom).

Each rule is an object with:

* ``rule_id``   — kebab-case id used in findings, pragmas and baselines
* ``hint``      — one-line fix hint appended to every finding
* ``check(tree, src, path)`` — AST pass returning ``[(line, message)]``

Rules are registered in :data:`RULES` (one module per rule under this
package). A rule decides its own path scope internally (the wall-clock
sub-check of ``nondeterminism`` only applies to step/serve paths under
``src/repro_torch``); files *outside* ``src/repro_torch`` — lint fixtures,
explicitly passed files — always get the full rule set, so the test
fixtures exercise every pattern wherever they sit.

This module holds the shared AST helpers the rules build on. Against the
reference's: ``unwrap_views`` also strips torch's value-preserving calls,
``inplace_mutations`` also counts torch's in-place methods, and
``in_repo_src`` keys on ``src/repro_torch``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional

# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

# calls that return the same values in another dtype, shape or layout
_VIEW_CALLS = ("astype", "reshape", "transpose", "swapaxes", "to", "float",
               "view", "t", "contiguous")
# torch's in-place writers, beside ``x[...] =`` and numpy's ``.fill``
_INPLACE_METHODS = ("fill", "copy_", "fill_", "zero_", "masked_fill_",
                    "index_copy_")


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted path of a Name/Attribute chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def unwrap_views(node: ast.AST) -> ast.AST:
    """Strip value-preserving wrappers (``.astype(...)``, ``.reshape(...)``,
    ``.transpose(...)``, ``.to(...)``, ``.float()``, ``.view(...)``,
    ``.t()``, ``.contiguous()``, ``.T``/``.mT``) so the underlying operand
    is classified, not the view chain."""
    while True:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _VIEW_CALLS):
            node = node.func.value
        elif isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            node = node.value
        else:
            return node


def functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def direct_body(fn: ast.FunctionDef) -> List[ast.AST]:
    """Walk a function's subtree, excluding nested function bodies (each
    nested def is its own binding scope)."""
    out: List[ast.AST] = []
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def module_body(tree: ast.Module) -> List[ast.AST]:
    """Module-level statements, excluding function bodies."""
    out: List[ast.AST] = []
    stack = [n for n in ast.iter_child_nodes(tree)]
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def in_repo_src(path: str) -> bool:
    return "src/repro_torch" in path.replace("\\", "/")


def _target(base: ast.AST, line: int):
    if isinstance(base, ast.Name):
        return "local", base.id, line
    if isinstance(base, ast.Attribute):
        return "attr", base.attr, line
    return None


def inplace_mutations(nodes: Iterable[ast.AST]):
    """Yield ``(kind, name, line)`` for in-place writes:
    ``x[...] = / x[...] op= / x.fill(...)`` and torch's ``x.copy_(...)``,
    ``.fill_``, ``.zero_``, ``.masked_fill_``, ``.index_copy_``, where x is
    a Name ('local') or an Attribute ('attr', keyed by the attribute
    name)."""
    for node in nodes:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _INPLACE_METHODS):
            hit = _target(node.func.value, node.lineno)
            if hit:
                yield hit
            continue
        for t in targets:
            if isinstance(t, ast.Subscript):
                hit = _target(t.value, node.lineno)
                if hit:
                    yield hit


WEIGHT_KEY = re.compile(r"^(w[a-z0-9_]*|embed[a-z0-9_]*|unembed[a-z0-9_]*)$")


def param_like(node: ast.AST, bindings: Dict[str, str]) -> Optional[str]:
    """Does this operand look like a model parameter leaf? Keys on the
    repo's weight naming convention: param dict keys / attribute names
    ``w*`` / ``embed*`` / ``unembed*``, or a local bound to one."""
    node = unwrap_views(node)
    if isinstance(node, ast.Attribute) and WEIGHT_KEY.match(node.attr):
        return dotted_name(node) or f".{node.attr}"
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if (isinstance(sl, ast.Constant) and isinstance(sl.value, str)
                and WEIGHT_KEY.match(sl.value)):
            return f"{dotted_name(node.value) or '<expr>'}[{sl.value!r}]"
    if isinstance(node, ast.Name) and node.id in bindings:
        return bindings[node.id]
    return None


# rule modules import the helpers above, so they import last
from .host_aliasing import HostAliasingRule          # noqa: E402
from .raw_weight_einsum import RawWeightEinsumRule   # noqa: E402
from .nondeterminism import NondeterminismRule       # noqa: E402
from .unguarded_state_write import UnguardedStateWriteRule  # noqa: E402

RULES = (
    HostAliasingRule(),
    RawWeightEinsumRule(),
    NondeterminismRule(),
    UnguardedStateWriteRule(),
)

RULE_IDS = tuple(r.rule_id for r in RULES)

__all__ = ["RULES", "RULE_IDS", "HostAliasingRule", "RawWeightEinsumRule",
           "NondeterminismRule", "UnguardedStateWriteRule", "dotted_name",
           "unwrap_views", "functions", "direct_body", "module_body",
           "in_repo_src", "inplace_mutations", "param_like", "WEIGHT_KEY"]
