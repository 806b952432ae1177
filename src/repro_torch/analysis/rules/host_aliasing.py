"""host-aliasing: ``torch.from_numpy``/``torch.as_tensor`` of a host-mutated buffer.

``torch.from_numpy(buf)`` always shares ``buf``'s memory, and
``torch.as_tensor(buf)`` does whenever the dtype allows; ``.to(device)``
is a no-op on the CPU, so chaining it saves nothing there. A host buffer
the engine mutates in place after step assembly (slot positions, reset
masks) then lets the step observe post-dispatch values. Two shapes are
flagged, as in the reference:

* an **attribute** buffer (``self._slot_pos``) with an in-place mutation
  site anywhere in the module — persistent state must always be
  snapshotted, mutation order is irrelevant across methods/steps;
* a **local** buffer mutated in place *after* the call (textually later,
  or anywhere in a shared enclosing loop — loop-carried buffers alias
  across iterations unless freshly reallocated inside the loop).

``torch.tensor(...)`` always copies and is never flagged. Sanctioned
escapes: stage through ``serve.engine.host_to_device`` (the one blessed
helper, which snapshots with ``.copy()``), or snapshot explicitly — any
*call* argument (``buf.copy()``, ``np.zeros(...)``) is accepted as a
fresh value.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from . import dotted_name, direct_body, functions, inplace_mutations

_ALIASING_CALLS = ("torch.from_numpy", "torch.as_tensor")


class HostAliasingRule:
    rule_id = "host-aliasing"
    hint = ("route through serve.engine.host_to_device(buf, device) (or "
            "snapshot with torch.from_numpy(buf.copy()))")

    def check(self, tree, src, path):
        findings = []
        mutated_attrs = {name for kind, name, _ in
                         inplace_mutations(ast.walk(tree)) if kind == "attr"}
        for fn in functions(tree):
            body = direct_body(fn)
            local_mut: Dict[str, List[int]] = {}
            for kind, name, line in inplace_mutations(body):
                if kind == "local":
                    local_mut.setdefault(name, []).append(line)
            loops = [(n.lineno, n.end_lineno) for n in body
                     if isinstance(n, (ast.For, ast.While))]
            rebinds: Dict[str, List[int]] = {}
            for n in body:
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            rebinds.setdefault(t.id, []).append(n.lineno)
            for node in body:
                if not (isinstance(node, ast.Call) and node.args
                        and dotted_name(node.func) in _ALIASING_CALLS):
                    continue
                call = dotted_name(node.func)
                arg = node.args[0]
                if isinstance(arg, ast.Call):
                    continue  # .copy() / fresh-constructor argument
                tgt = arg.value if isinstance(arg, ast.Subscript) else arg
                if isinstance(tgt, ast.Attribute) and tgt.attr in mutated_attrs:
                    findings.append((node.lineno, (
                        f"{call} of in-place-mutated host buffer "
                        f"'.{tgt.attr}' — a persistent buffer the host "
                        "mutates between steps shares its memory with the "
                        "step's tensor")))
                elif isinstance(tgt, ast.Name) and tgt.id in local_mut:
                    muts = local_mut[tgt.id]
                    later = any(m > node.lineno for m in muts)
                    shared_loop = any(
                        lo <= node.lineno <= hi
                        and any(lo <= m <= hi for m in muts)
                        and not any(lo <= rb <= hi
                                    for rb in rebinds.get(tgt.id, []))
                        for lo, hi in loops)
                    if later or shared_loop:
                        findings.append((node.lineno, (
                            f"{call} of host buffer '{tgt.id}' that is "
                            "mutated in place after staging — the step may "
                            "observe the post-mutation values")))
        return findings
