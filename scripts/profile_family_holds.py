"""Where the CPU side of ``chip_smoke.py``'s family holds spends its time.

For each family named, at its hold depth of full width in f32
(``chip_smoke.hold_config``), on the CPU with ``--threads`` intra-op
threads (default: all but ``chip_smoke.FAMILY_DRIVER_THREADS``, as the
phase's worker has them), this times:

* the holds as the phase makes them (``chip_smoke.hold_side``: "ce",
  "qat", "fisher"), each on its own;
* the QAT distillation step split by stage: the teacher's forward,
  ``fake_quant_ste`` over the plan (the embedding tables apart from the
  rest, and within the tables the block scales, the nearest-code search,
  the code-to-value gather and the straight-through sum), the student's
  forward, the KL, the backward, the gradient norm;
* the weight Fisher split by stage: the forward with the sampled-label
  loss, the backward, the square of each gradient, the two-stage
  accumulator's sum and mean, the per-tensor statistics;
* with ``--candidates``, other forms of the nearest-code search and of
  the code-to-value gather on the two largest planned leaves, each checked
  bit for bit.

The weights are the phase's (``init`` from seed 0) and so is the batch
(``chip_smoke.family_batch``). Prints one JSON line a family and writes
them to ``--out``. Run it on the host of the card (the holds' CPU side
runs there): a 2-layer hold of qwen2-moe-a2.7b or internvl2-26b holds
1.8-2.0 B parameters in f32 and its QAT step peaks near 40 GB.

  python3 scripts/profile_family_holds.py --archs qwen2-moe-a2.7b \
      internvl2-26b [--layers 2] [--threads 7] [--repeat 2] [--variant smoke]
      [--candidates]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import fisher  # noqa: E402
from repro_torch.core.plan import flat_with_paths, map_with_paths  # noqa
from repro_torch.models.api import get_family  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train.qat import qat_plan_for  # noqa: E402

TABLES = ("['embed']", "['unembed']")


class Laps:
    """Seconds by stage name, summed over the laps that name it."""

    def __init__(self):
        self.secs, self.t0 = {}, time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        self.secs[name] = self.secs.get(name, 0.0) + now - self.t0
        self.t0 = now


def fake_quant_split(f, x, laps, tag):
    """``f.fake_quant_ste(x)`` by stage; the same values."""
    with torch.no_grad():
        x32 = x.float()
        xb, scales, unblock = f.scaling.normalise(x32)
        laps.lap(f"fake_quant_{tag}_scales")
        codes = f.element.quantise(xb)
        laps.lap(f"fake_quant_{tag}_search")
        vals = f.element.dequantise(codes)
        laps.lap(f"fake_quant_{tag}_gather")
        x_hat = unblock(vals * scales).to(x.dtype)
        laps.lap(f"fake_quant_{tag}_rescale")
    out = x + (x_hat - x).detach()
    laps.lap(f"fake_quant_{tag}_ste")
    return out


def qat_split(hold, params, batch, plan):
    fam = get_family(hold.family)
    laps = Laps()
    with torch.no_grad():
        ref = fam.apply(params, batch, hold)
    laps.lap("teacher_forward")
    names = [n for n, _ in flat_with_paths(params)]
    leaves = {n: x.detach().requires_grad_(True)
              for n, x in flat_with_paths(params)}
    laps.lap("leaves")
    student = {}
    for n in names:
        f = plan.formats.get(n)
        if f is None:
            student[n] = leaves[n]
        else:
            student[n] = fake_quant_split(
                f, leaves[n], laps, "tables" if n in TABLES else "rest")
    tree = map_with_paths(lambda n, _: student[n], params)
    laps.lap("fake_quant_other")
    logits = fam.apply(tree, batch, hold)
    laps.lap("student_forward")
    loss = loop.full_kl_loss(ref, logits)
    laps.lap("kl")
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    laps.lap("backward")
    norm = float(loop.global_norm(dict(zip(names, grads))))
    laps.lap("grad_norm")
    return dict(kl=float(loss.detach()), grad_norm=norm, seconds=laps.secs)


def fisher_split(hold, params, batch, seed=5):
    fam = get_family(hold.family)
    laps = Laps()
    names = [n for n, _ in flat_with_paths(params)]
    leaves = {n: x.detach().requires_grad_(True)
              for n, x in flat_with_paths(params)}
    tree = map_with_paths(lambda n, _: leaves[n], params)
    hooks = chip_smoke.ThreadHooks()
    with hooks:
        loss = hooks.pinned(lambda: fisher.one_loss(
            lambda p, b: fam.apply(p, b, hold), tree,
            {k: v[0] for k, v in batch.items()}, None), seed)
    laps.lap("forward_and_labels")
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    laps.lap("backward")
    del loss, tree, leaves
    sq = [g.float().square_() for g in grads]
    del grads
    laps.lap("square")
    acc = fisher.TwoStageAccumulator(params, lazy_host=True)
    acc.add(map_with_paths(lambda n, _: sq[names.index(n)], params))
    del sq
    n_tok = int(batch[min(batch)].shape[0] * batch[min(batch)].shape[1])
    mean = acc.mean(n_tok)
    del acc
    laps.lap("accumulate_and_mean")
    stats = fisher.per_tensor_stats(params, mean)
    laps.lap("per_tensor_stats")
    return dict(tensors=len(stats), seconds=laps.secs)


def search_candidates(f, params, names):
    """Seconds of other forms of the nearest-code search and the gather on
    ``names``' blocks (each held bit for bit to the plan's own): the
    comparison sum Σ[x > midᵢ] on uint8, ``torch.bucketize``, and the
    gather by int32 codes through ``index_select``."""
    el = f.element
    mids, cps = el.midpoints(), el.torch_codepoints()
    out = {}
    for n in names:
        with torch.no_grad():
            xb, _, _ = f.scaling.normalise(params[n].float())
            laps = Laps()
            want = el.quantise(xb)
            laps.lap("searchsorted")
            vals = el.dequantise(want)
            laps.lap("gather_long")
            codes = torch.zeros(xb.shape, dtype=torch.uint8)
            for m in mids.tolist():
                codes += xb > m
            laps.lap("compare_sum")
            same_cmp = torch.equal(codes, want)
            del codes
            laps.lap("check")
            b = torch.bucketize(xb, mids, right=False, out_int32=True)
            laps.lap("bucketize")
            same_b = torch.equal(b.to(torch.uint8), want)
            laps.lap("check")
            v2 = torch.index_select(cps, 0, b.reshape(-1)).reshape(xb.shape)
            laps.lap("gather_index_select_int32")
            same_v = torch.equal(v2, vals)
        laps.secs.pop("check")
        out[n] = dict(seconds=laps.secs, compare_sum_equal=same_cmp,
                      bucketize_equal=same_b, index_select_equal=same_v)
    return out


def profile(arch, layers, repeat, variant="full", candidates=False):
    full = configs.get_config(arch, variant)
    hold = chip_smoke.hold_config(full, layers)
    fam = get_family(hold.family)
    plan = qat_plan_for(fam.param_specs(hold), chip_smoke.FAMILY_QAT_SPEC)
    t0 = time.perf_counter()
    params = fam.init(hold, seed=0, device="cpu")
    batch = chip_smoke.family_batch(hold, torch.device("cpu"))
    out = dict(arch=arch, layers=layers, threads=torch.get_num_threads(),
               params=sum(x.numel() for _, x in flat_with_paths(params)),
               table_params=sum(x.numel() for n, x in flat_with_paths(params)
                                if n in TABLES),
               init_s=time.perf_counter() - t0, holds=[], qat=[], fisher=[])
    with chip_smoke.ThreadHooks() as hooks:
        for _ in range(repeat):
            for h in ("ce", "qat", "fisher"):
                got, secs = chip_smoke.hold_side(hooks, hold, params, batch,
                                                 plan, (h,))
                out["holds"].append(secs)
                if h == "qat":
                    out["qat_hold"] = got["qat"]
    for _ in range(repeat):
        out["qat"].append(qat_split(hold, params, batch, plan))
        out["fisher"].append(fisher_split(hold, params, batch))
    if candidates:
        flat = dict(flat_with_paths(params))
        big = sorted((n for n in flat if plan.formats.get(n) is not None),
                     key=lambda n: -flat[n].numel())[:2]
        out["search_candidates"] = search_candidates(
            plan.formats[big[0]], flat, big)
    out["host_peak_rss_bytes"] = chip_smoke.host_peak_rss()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", nargs="+",
                    default=[chip_smoke.MOE_ARCH, chip_smoke.INTERNVL_ARCH])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--variant", default="full",
                    help="smoke: a seconds-fast rehearsal on any host")
    ap.add_argument("--threads", type=int, default=max(
        1, torch.get_num_threads() - chip_smoke.FAMILY_DRIVER_THREADS))
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--candidates", action="store_true",
                    help="also time the other search and gather forms")
    ap.add_argument("--out", default=str(ROOT / "runs" /
                                         "profile_family_holds.jsonl"))
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for arch in args.archs:
        row = profile(arch, args.layers, args.repeat, args.variant,
                      args.candidates)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
