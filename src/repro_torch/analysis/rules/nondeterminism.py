"""nondeterminism: hidden-global randomness / wall clock in step paths.

Serving is drilled on bit-determinism — traffic replay signatures
(``serve.traffic.deterministic_signature``), greedy-parity gates,
per-(rid, token-index) sampling seeds. Unseeded global-state randomness
or wall-clock reads inside a step/serve path silently break replay
without failing any test. Flagged:

* numpy's legacy samplers (``np.random.<sampler>``) and the stdlib
  ``random`` module, as in the reference;
* torch samplers drawing from the global generator — ``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial`` and the ``*_like`` forms, and the in-place tensor
  methods ``.uniform_``, ``.normal_``, ``.random_``, ``.exponential_``,
  ``.bernoulli_`` — called without ``generator=``;
* the global reseeds ``torch.manual_seed`` and ``torch.seed`` (and their
  ``torch.random`` / ``torch.cuda`` forms), which reach every caller's
  stream;
* ``time.time`` in a step path.

Seed explicitly through ``np.random.default_rng(seed)`` or a
``torch.Generator`` threaded from the caller; use ``time.monotonic()`` for
latency metrics — it is allowed everywhere because it only feeds
accounting, never compute.

Scope: every check but the wall clock applies to every linted file; the
``time.time`` check applies only to step/serve paths
(``src/repro_torch/serve``, ``src/repro_torch/models``,
``src/repro_torch/kernels``) — training loops and launch scripts
legitimately report wall-clock throughput. Files outside
``src/repro_torch`` (fixtures, explicit paths) get the full rule.
"""
from __future__ import annotations

import ast

from . import dotted_name, in_repo_src

_NP_LEGACY = {
    "rand", "randn", "randint", "random", "random_sample", "ranf", "sample",
    "choice", "shuffle", "permutation", "normal", "uniform",
    "standard_normal", "poisson", "exponential", "beta", "binomial",
    "gamma", "gumbel", "laplace", "logistic", "lognormal", "seed",
}
_STDLIB_RANDOM = {"random", "randint", "choice", "shuffle", "uniform",
                  "randrange", "sample", "seed", "gauss", "betavariate"}
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like"}
_TENSOR_SAMPLERS = {"uniform_", "normal_", "random_", "exponential_",
                    "bernoulli_"}
_TORCH_RESEEDS = {"torch.manual_seed", "torch.seed",
                  "torch.random.manual_seed", "torch.random.seed",
                  "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_STEP_DIRS = ("src/repro_torch/serve", "src/repro_torch/models",
              "src/repro_torch/kernels")


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


class NondeterminismRule:
    rule_id = "nondeterminism"
    hint = ("seed via np.random.default_rng(seed) or a torch.Generator "
            "passed as generator=; use time.monotonic() for timing metrics")

    def check(self, tree, src, path):
        p = path.replace("\\", "/")
        step_path = (not in_repo_src(p) or any(d in p for d in _STEP_DIRS))
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in ("time.time", "time.time_ns") and step_path:
                findings.append((node.lineno, (
                    f"{name}() in a step/serve path — wall clock is "
                    "nondeterministic across replays")))
                continue
            parts = name.split(".")
            if (len(parts) == 3 and parts[0] in ("np", "numpy")
                    and parts[1] == "random" and parts[2] in _NP_LEGACY):
                findings.append((node.lineno, (
                    f"unseeded legacy {name}() draws from (or reseeds) "
                    "numpy's hidden global RNG state")))
            elif (len(parts) == 2 and parts[0] == "random"
                    and parts[1] in _STDLIB_RANDOM):
                findings.append((node.lineno, (
                    f"stdlib {name}() draws from hidden global RNG "
                    "state")))
            elif name in _TORCH_RESEEDS:
                findings.append((node.lineno, (
                    f"{name}() reseeds torch's global generator under "
                    "every other caller")))
            elif (len(parts) == 2 and parts[0] == "torch"
                    and parts[1] in _TORCH_SAMPLERS
                    and not _has_generator(node)):
                findings.append((node.lineno, (
                    f"{name}() without generator= draws from torch's "
                    "hidden global RNG state")))
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_SAMPLERS
                    and not _has_generator(node)):
                findings.append((node.lineno, (
                    f".{node.func.attr}() without generator= draws from "
                    "torch's hidden global RNG state")))
        return findings
