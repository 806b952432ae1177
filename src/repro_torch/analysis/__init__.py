"""repro_torch.analysis — the port's static serving-invariant linter and
registry contract verifier (the reference's ``repro/analysis`` in torch
form).

Two halves:

* **Lint** (``repro_torch.analysis.lint`` + ``rules/``): AST rules
  ``host-aliasing`` (``torch.from_numpy``/``torch.as_tensor`` of a host
  buffer mutated in place), ``raw-weight-einsum`` (a parameter contracted
  outside ``layers.linear``/``expert_matmul``/``embed_lookup``),
  ``nondeterminism`` (global-generator torch and numpy samplers, global
  reseeds, ``time.time`` in step paths), ``unguarded-state-write`` (a
  ``decode_step`` outside the ragged reset protocol); per-line
  ``# lint:allow(rule-id) <reason>`` pragmas and a checked-in baseline
  (empty on the merged tree).
* **Contracts** (``repro_torch.analysis.contracts``): for every
  registered ``ModelFamily`` × smoke config, verify ``pack_layouts``
  paths/subscripts against the param tree, ``decode_state_specs``/
  ``cache_spec``/``state_keys`` agreement, and that ``supports_ragged``
  matches what ``decode_step`` accepts on ``meta`` tensors — abstract
  evaluation only, no FLOPs.

CLI: ``python -m repro_torch.analysis`` (see ``__main__.py``); its clean
run over ``src/repro_torch`` is a tier-1 test
(``tests/test_torch_analysis.py``).
"""
from .lint import (Finding, lint_file, lint_paths, load_baseline,
                   partition, save_baseline, DEFAULT_BASELINE)
from .rules import RULES, RULE_IDS
from .contracts import ContractReport, default_matrix, verify_all, \
    verify_family

__all__ = ["Finding", "lint_file", "lint_paths", "load_baseline",
           "partition", "save_baseline", "DEFAULT_BASELINE", "RULES",
           "RULE_IDS", "ContractReport", "default_matrix", "verify_all",
           "verify_family"]
