"""unguarded-state-write: decode steps outside the ragged reset protocol.

Every ``decode_step`` advances per-slot state by exactly ``t_valid``
tokens and honours the ``batch["reset"]`` mask — zeroing a reused slot's
recurrent/conv/KV state and position inside the step — so no request ever
observes its predecessor's state. The canonical implementation is the
shared ``models.api.ragged_prologue`` / ``ring_prologue`` (which wipe a
reset slot's rows in place with ``masked_fill_``); delegating to another
family's guarded ``decode_step`` (internvl → transformer) is equally fine.

The rule fires once, at the ``def`` line, on any function named
``decode_step`` (or ``*_decode_step``) with **none** of: a prologue
call, a decode_step delegation, or explicit ``"t_valid"`` *and*
``"reset"`` handling. Such a step mutates per-slot state unguarded — the
cross-request state-leak bug class.
"""
from __future__ import annotations

import ast

from . import dotted_name, functions

_PROLOGUES = {"ragged_prologue", "ring_prologue"}


class UnguardedStateWriteRule:
    rule_id = "unguarded-state-write"
    hint = ("run models.api.ragged_prologue/ring_prologue (or delegate to "
            "a guarded decode_step) before touching per-slot state")

    def check(self, tree, src, path):
        findings = []
        for fn in functions(tree):
            if not (fn.name == "decode_step"
                    or fn.name.endswith("_decode_step")):
                continue
            guarded = False
            saw_tvalid = saw_reset = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func).rsplit(".", 1)[-1]
                    if name in _PROLOGUES or name.endswith("decode_step"):
                        guarded = True
                        break
                if isinstance(node, ast.Constant):
                    saw_tvalid |= node.value == "t_valid"
                    saw_reset |= node.value == "reset"
            if guarded or (saw_tvalid and saw_reset):
                continue
            findings.append((fn.lineno, (
                f"decode step '{fn.name}' updates per-slot state without "
                "honouring t_valid/batch['reset'] — a reused serving slot "
                "would observe its predecessor's state")))
        return findings
