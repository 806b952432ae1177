"""raw-weight-einsum: parameter contraction outside the projection API.

Every family serves packed quantised weights only because
``models.layers.linear`` / ``expert_matmul`` / ``embed_lookup`` are the
*single* way a parameter is contracted: a raw ``torch.einsum``,
``matmul``, ``mm``, ``bmm``, ``tensordot``, ``F.linear`` or ``@``
against a param leaf either densifies packed codes or fails on a
``PackedTensor``, and the fused ``dequant_matmul`` kernel is bypassed.

The rule keys on the **operand**, not the op: a contraction is flagged
only when one of its operands looks like a parameter leaf under the repo's
weight naming convention — a ``w*``/``embed*``/``unembed*`` attribute
(``p.w_router``), a string-keyed subscript (``params["wq"]``,
``lp['w_down']``), or a local bound to one — optionally wrapped in
``.to(...)``/``.float()``/``.reshape(...)``/``.t()`` and the like. For
``F.linear`` that is its weight operand; for a method call
(``x.matmul(w)``) the receiver counts as an operand. Activation-only
contractions (attention scores, WKV/SSD chunk math, softmax
probabilities) never match. The bodies of the API functions themselves
(``linear``, ``expert_matmul``, ``embed_lookup``) are not checked.
Genuinely non-packable contractions carry
``# lint:allow(raw-weight-einsum) <reason>``.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from . import direct_body, dotted_name, functions, module_body, param_like

_MATMUL_CALLEES = (".einsum", ".matmul", ".mm", ".bmm", ".tensordot")
_LINEAR_CALLEES = ("F.linear", "torch.nn.functional.linear",
                   "nn.functional.linear", "functional.linear")
# module prefixes whose attribute calls are functions, not tensor methods
_MODULES = ("torch", "torch.linalg", "np", "numpy")
_API = ("linear", "expert_matmul", "embed_lookup")


def _operands(n: ast.AST):
    """(operands, op name) of a contraction node, else ([], None)."""
    if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult):
        return [n.left, n.right], "@"
    if not isinstance(n, ast.Call):
        return [], None
    name = dotted_name(n.func)
    if name in _LINEAR_CALLEES:
        weight = [k.value for k in n.keywords if k.arg == "weight"]
        return (n.args[1:2] or weight), "F.linear"
    if any(name.endswith(c) for c in _MATMUL_CALLEES):
        ops = list(n.args)
        receiver = n.func.value
        if dotted_name(receiver) not in _MODULES:
            ops.insert(0, receiver)
        return ops, name.rsplit(".", 1)[-1]
    return [], None


class RawWeightEinsumRule:
    rule_id = "raw-weight-einsum"
    hint = ("route through layers.linear / layers.expert_matmul "
            "(or '# lint:allow(raw-weight-einsum) <reason>' for a "
            "genuinely non-packable contraction)")

    def check(self, tree, src, path):
        findings = []
        scopes: List[List[ast.AST]] = [direct_body(fn)
                                       for fn in functions(tree)
                                       if fn.name not in _API]
        scopes.append(module_body(tree))
        for nodes in scopes:
            bindings: Dict[str, str] = {}
            for n in nodes:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name):
                    desc = param_like(n.value, {})
                    if desc:
                        bindings[n.targets[0].id] = desc
            for n in nodes:
                operands, where = _operands(n)
                for op in operands:
                    desc = param_like(op, bindings)
                    if desc:
                        findings.append((n.lineno, (
                            f"raw {where} against param leaf {desc} "
                            "bypasses the packed projection API — a "
                            "PackedTensor here densifies (or fails)")))
                        break
        return findings
