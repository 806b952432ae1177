"""Registry contract verifier: every ``ModelFamily`` × small config.

The invariants the serving stack relies on at run time — packed coverage
through ``pack_layouts``, grouped decode-cache geometry, the ragged
protocol — are all *declarations* a family makes at registration. This
module checks the declarations against the family's actual callables
**abstractly**: on ``meta`` tensors, which carry shapes and dtypes and no
storage, so nothing is computed (the counterpart of the reference's
``jax.eval_shape``). The checks are the reference's:

* ``pack_layouts`` paths exist in the ``param_specs`` tree and their
  ``(n_lead, n_contract)`` subscripts are consistent with the declared
  parameter rank (at least one output dim must remain for the scale
  block to tile);
* ``decode_state_specs`` / ``cache_spec`` / ``CacheSpec.state_keys``
  agree: every grouped KV entry the cache geometry owns exists in the
  decode-state tree with the identical shape/dtype, and ``pos`` is the
  per-slot ``(B,) int32`` the ragged protocol requires;
* ``supports_ragged`` matches what ``decode_step`` accepts on meta
  tensors under ``torch.no_grad()``: a ``(B, T)`` chunk with ``t_valid``
  + ``reset`` (and the plain ``T=1`` decode call) must run, return
  ``(B, T, ·)`` logits, and hand back a state tree of the identical
  keys/shapes/dtypes — the fixed-point property the engine's step loop
  relies on;
* the same declarations re-verified under a quantised ``kv_format``
  (q4, or q8 for an odd head dim).

A step that reads a tensor's value (``.item()``, ``bool(t)``,
``.tolist()``, ``.cpu()``, numpy) fails on ``meta``: such a read would
also stall the card's stream every step, so it is reported.

The default matrix pairs every registered family with every architecture's
``smoke()`` config (``repro_torch.configs.ARCHS``), so a new family or
config inherits verification by existing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .lint import Finding


@dataclass(frozen=True)
class ContractReport:
    tag: str
    family: str
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        return not self.findings


def default_matrix() -> List[Tuple[str, object]]:
    """(tag, smoke config) for every architecture."""
    from repro_torch import configs
    return [(arch_id, configs.get_config(arch_id, "smoke"))
            for arch_id in sorted(configs.ARCHS)]


def _signature(state) -> Optional[dict]:
    """{key: (shape, dtype)} of a state tree, or None if it is no dict."""
    if not isinstance(state, dict):
        return None
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in state.items()}


def verify_family(tag: str, cfg, *, batch: int = 2, kv_len: int = 24,
                  slack: int = 4, chunk: int = 4) -> ContractReport:
    """Verify one (tag, config) pair; abstract evaluation only."""
    import torch

    from repro_torch.core.plan import flat_with_paths
    from repro_torch.models.api import get_family, specs_to_sds

    fam = get_family(cfg.family)
    path = f"contracts:{tag}"
    findings: List[Finding] = []

    def fail(msg: str, hint: str = ""):
        findings.append(Finding(path, 0, "contract", msg, hint))

    # ---- pack_layouts paths + subscript consistency ----------------------
    specs = fam.param_specs(cfg)
    by_path = dict(flat_with_paths(specs))
    layouts = fam.pack_layouts(cfg)
    for lpath, layout in layouts.items():
        if lpath not in by_path:
            fail(f"pack_layouts path {lpath} not in the param tree "
                 f"(family {fam.name!r}); known leaves e.g. "
                 f"{sorted(by_path)[:3]}...",
                 "declare the layout against an existing param path")
            continue
        try:
            n_lead, n_contract = layout
        except (TypeError, ValueError):
            fail(f"pack_layouts[{lpath}] = {layout!r} is not an "
                 "(n_lead, n_contract) pair")
            continue
        spec = by_path[lpath]
        if n_lead < 0 or n_contract < 1:
            fail(f"pack_layouts[{lpath}] = {layout!r}: need n_lead >= 0 "
                 "and n_contract >= 1")
        elif len(spec.shape) < n_lead + n_contract + 1:
            fail(f"pack_layouts[{lpath}] = {layout!r} inconsistent with "
                 f"param rank {len(spec.shape)} (shape {spec.shape}): no "
                 "output dim remains for the scale block to tile")

    # ---- decode_state_specs / cache_spec / state_keys agreement ----------
    if fam.decode_state_specs is None:
        return ContractReport(tag, fam.name, tuple(findings))
    dss = fam.decode_state_specs(cfg, batch, kv_len, slack, True)
    pos = dss.get("pos") if isinstance(dss, dict) else None
    if pos is None or tuple(pos.shape) != (batch,) or pos.dtype != "int32":
        fail(f"decode_state_specs must declare per-slot 'pos' as "
             f"((batch,), int32); got {pos and (pos.shape, pos.dtype)}",
             "the ragged protocol keys on state['pos']: (B,) int32")
    if fam.cache_spec is not None:
        cs = fam.cache_spec(cfg, batch, kv_len, slack, True)
        cache_specs = cs.state_specs()
        for key in cs.state_keys:
            if key not in dss:
                fail(f"cache_spec owns state key {key!r} that "
                     "decode_state_specs does not declare",
                     "grouped k{g}/v{g} entries must ride the state tree")
                continue
            want, got = cache_specs[key], dss[key]
            if tuple(want.shape) != tuple(got.shape) \
                    or want.dtype != got.dtype:
                fail(f"state key {key!r}: cache_spec declares "
                     f"{want.shape}/{want.dtype} but decode_state_specs "
                     f"declares {got.shape}/{got.dtype}")

    # ---- supports_ragged vs what decode_step actually accepts ------------
    if fam.decode_step is None:
        if fam.supports_ragged:
            fail("supports_ragged=True but decode_step is None")
        return ContractReport(tag, fam.name, tuple(findings))
    params_sds = specs_to_sds(specs)

    def step(c, state_specs, T, ragged):
        """decode_step on meta tensors: (logits, new state)."""
        b = {"tokens": torch.empty((batch, T), dtype=torch.int32,
                                   device="meta")}
        if ragged:
            b["t_valid"] = torch.empty((batch,), dtype=torch.int32,
                                       device="meta")
            b["reset"] = torch.empty((batch,), dtype=torch.bool,
                                     device="meta")
        with torch.no_grad():
            return fam.decode_step(params_sds, specs_to_sds(state_specs), b,
                                   c)

    in_tree = _signature(specs_to_sds(dss))
    calls = ([(chunk, True), (1, False)] if fam.supports_ragged
             else [(1, False)])
    for T, ragged in calls:
        kind = (f"ragged (B, {T}) chunk + t_valid/reset" if ragged
                else "plain T=1 decode")
        try:
            logits, new_state = step(cfg, dss, T, ragged)
        except Exception as e:  # noqa: BLE001 — report, never crash
            fail(f"decode_step rejects the {kind} call the "
                 f"supports_ragged={fam.supports_ragged} declaration "
                 f"promises: {type(e).__name__}: {e}",
                 "the engine's step makes exactly this call; a read of "
                 "a tensor's value fails on meta tensors")
            continue
        if tuple(logits.shape[:2]) != (batch, T):
            fail(f"decode_step {kind}: logits shaped {tuple(logits.shape)}, "
                 f"expected leading ({batch}, {T})")
        out_tree = _signature(new_state)
        if out_tree != in_tree:
            only_in = sorted(set(in_tree) - set(out_tree or {}))
            only_out = sorted(set(out_tree or {}) - set(in_tree))
            diff = {k: (in_tree[k], (out_tree or {}).get(k))
                    for k in in_tree if k in (out_tree or {})
                    and (out_tree or {})[k] != in_tree[k]}
            fail(f"decode_step {kind}: state is not a fixed point of the "
                 f"declared specs (dropped={only_in}, added={only_out}, "
                 f"reshaped={diff})",
                 "the engine feeds state back verbatim every step")

    # ---- quantised cache formats -----------------------------------------
    # re-verify the same declarations with a quantised kv_format: the cache
    # geometry must grow uint8 code + float32 scale entries per group, the
    # decode-state tree must carry them identically, and decode_step must
    # run (and fix-point) against the quantised state.
    if fam.cache_spec is not None and fam.supports_ragged:
        qfmt = "q4" if cfg.hd % 2 == 0 else "q8"
        qcfg = cfg.replace(kv_format=qfmt)
        qcs = fam.cache_spec(qcfg, batch, kv_len, slack, True)
        qspecs = qcs.state_specs()
        for g in qcs.groups:
            if not g.quantised:
                fail(f"cache_spec ignores cfg.kv_format={qfmt!r}: group "
                     f"{g.index} stayed {g.fmt!r}",
                     "pass formats=cfg.kv_format to build_cache_spec")
                continue
            code, scale = qspecs[g.k_key], qspecs[g.k_scale_key]
            if code.dtype != "uint8":
                fail(f"quantised group {g.index}: codes declared "
                     f"{code.dtype}, expected uint8")
            if scale.dtype != "float32" or tuple(scale.shape)[-1] != 1:
                fail(f"quantised group {g.index}: scales declared "
                     f"{scale.shape}/{scale.dtype}, expected per-(token, "
                     "head) float32 with trailing dim 1")
        qdss = fam.decode_state_specs(qcfg, batch, kv_len, slack, True)
        for key in qcs.state_keys:
            if key not in qdss:
                fail(f"quantised cache key {key!r} missing from "
                     f"decode_state_specs under kv_format={qfmt!r}",
                     "codes + scales must ride the state tree")
                continue
            want, got = qspecs[key], qdss[key]
            if tuple(want.shape) != tuple(got.shape) \
                    or want.dtype != got.dtype:
                fail(f"quantised state key {key!r}: cache_spec declares "
                     f"{want.shape}/{want.dtype} but decode_state_specs "
                     f"declares {got.shape}/{got.dtype}")
        try:
            _, qnew = step(qcfg, qdss, chunk, True)
        except Exception as e:  # noqa: BLE001 — report, never crash
            fail(f"decode_step rejects the ragged chunk under "
                 f"kv_format={qfmt!r}: {type(e).__name__}: {e}",
                 "the quantised cache must serve through the same step")
        else:
            if _signature(qnew) != _signature(specs_to_sds(qdss)):
                fail(f"decode_step under kv_format={qfmt!r}: state is not "
                     "a fixed point of the quantised specs",
                     "codes/scales entries must round-trip the step")
    return ContractReport(tag, fam.name, tuple(findings))


def verify_all(matrix: Optional[Sequence[Tuple[str, object]]] = None
               ) -> List[ContractReport]:
    """Verify the full matrix (default: every architecture's smoke config).
    Every registered family must be covered — a family that no config
    exercises is itself a contract violation."""
    from repro_torch.models import api as mapi
    mx = list(matrix) if matrix is not None else default_matrix()
    reports = [verify_family(tag, cfg) for tag, cfg in mx]
    if matrix is None:
        mapi.get_family("transformer")  # force side-effect registration
        covered = {r.family for r in reports}
        missing = sorted(set(mapi._FAMILIES) - covered)
        if missing:
            reports.append(ContractReport(
                "registry", ",".join(missing), (Finding(
                    "contracts:registry", 0, "contract",
                    f"registered families {missing} are exercised by no "
                    "config — add a smoke config or retire them",
                    "every ModelFamily must be reachable from "
                    "repro_torch.configs.ARCHS"),)))
    return reports


__all__ = ["ContractReport", "default_matrix", "verify_family",
           "verify_all"]
