"""llama4-scout-17b-a16e as the card serves it whole: its full-size bytes
against the reference's packing rules on abstract arrays, and the draw
that makes its 128.85-GB f32 expert stacks one layer slice at a time
(``models.api.SlicedLeaf``), held at smoke size on the CPU with the slicing
constant lowered: the packed engine equals ``from_quantised`` over the tree
assembled from the same slices, and ``launch.serve`` serves its tokens.
Also: no leaf of a model served whole on the card crosses the constant,
and ``chip_smoke.py``'s llama4 constants agree with the config."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.models import api, transformer
from repro_torch.models.api import SlicedLeaf, family_leaves
from repro_torch.serve.engine import Request, ServeEngine, build_packed_engine

from test_torch_whisper import meta_weight_bytes, reference_full_bytes

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
SPEC = "babsmax16:n4"            # smoke widths (wk, wv: 32) tile by 16
EXPERTS = ["['layers']['we_down']", "['layers']['we_gate']",
           "['layers']['we_up']"]
# smoke's expert stacks are 262,144 f32 bytes, its other leaves <= 65,536
SMOKE_SLICE_BYTES = 100_000
SMOKE_CHUNK_ELEMS = 4096         # embed and unembed in 4 chunks of rows
# the models served whole on the card, and their variants there
SERVED = [("paper-100m", "full"), ("paper-100m", "small"),
          ("deepseek-7b", "full"), ("internlm2-20b", "full"),
          ("gemma3-1b", "full"), ("qwen2-moe-a2.7b", "full"),
          ("whisper-large-v3", "full"), ("internvl2-26b", "full"),
          ("rwkv6-1.6b", "full"), ("zamba2-2.7b", "full")]
SEED, KV_LEN = 2, 32


@pytest.fixture
def sliced(monkeypatch):
    """The slicing constant lowered so that smoke's three expert stacks,
    and only they, are drawn in slices; ``pack_leaf``'s row chunk lowered
    so that the embed and the unembed are quantised in chunks."""
    monkeypatch.setattr(api, "SLICE_LEAF_BYTES", SMOKE_SLICE_BYTES)
    monkeypatch.setattr(plan_mod, "PACK_CHUNK_ELEMS", SMOKE_CHUNK_ELEMS)
    return configs.get_config(ARCH, "smoke")


def assembled(cfg, seed):
    """The leaves of ``family_leaves`` with every sliced leaf assembled
    from its slices, and the names of the sliced ones."""
    tree, names = {}, []
    for name, x in family_leaves(cfg, seed=seed, device="cpu"):
        if isinstance(x, SlicedLeaf):
            names.append(name)
            x = x.whole()
        tree[name] = x
    return tree, names


def prompts(vocab, seed=SEED, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 4).tolist() for _ in range(n)]


def greedy(eng, vocab, max_new=5):
    for rid, p in enumerate(prompts(vocab)):
        eng.submit(Request(prompt=p, max_new_tokens=max_new, rid=rid))
    return {g.rid: g.tokens for g in eng.run()}


# ---------------------------------------------------------------------------
# (a) full-size bytes, by the reference's own rules on abstract arrays


@pytest.mark.parametrize("layers,want", [
    (48, dict(total=57_268_101_888, codes=53_882_716_160,
              scales=3_367_669_760, codebooks=768, dense=17_715_200)),
    (1, dict(total=2_269_348_608, codes=2_135_490_560, scales=133_468_160,
             codebooks=768, dense=389_120)),
    (2, dict(total=3_439_534_848, codes=3_236_495_360, scales=202_280_960,
             codebooks=768, dense=757_760))])
def test_full_weight_bytes_equal_the_reference(layers, want):
    """llama4 full at 48 layers and at 1 and 2 layers (the card's hold
    takes ``LLAMA4_HOLD_LAYERS``): 12 packed tensors (the router dense),
    the reference's count, which ``chip_smoke.py`` holds its engines
    to."""
    cfg = configs.get_config(ARCH, "full").replace(n_layers=layers)
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(
        jconfigs.get_config(ARCH, "full").replace(n_layers=layers))
    assert got == want
    if layers in (48, chip_smoke.LLAMA4_HOLD_LAYERS):
        key = ARCH if layers == 48 else ARCH + " hold"
        assert chip_smoke.WEIGHT_BYTES[key] == want


@pytest.mark.parametrize("fmt,kv", [("", 207_618_048), ("q8", 107_053_056)])
def test_full_kv_bytes_equal_the_reference(fmt, kv):
    """4 slots of kv_len 256 + chunk 8 at 48 layers, 8 KV heads of 128:
    the dense (bf16) and q8 caches."""
    cfg = configs.get_config(ARCH, "full").replace(kv_format=fmt)
    jcfg = jconfigs.get_config(ARCH, "full").replace(kv_format=fmt)
    got = transformer.cache_spec(cfg, 4, 256, slack=8).cache_bytes()
    assert got == jt.cache_spec(jcfg, 4, 256, slack=8).cache_bytes()
    assert got["kv"] == kv == chip_smoke.LLAMA4_KV_BYTES[fmt or "dense"]


# ---------------------------------------------------------------------------
# (b) the sliced draw, packed leaf by leaf and slice by slice


def test_sliced_engine_equals_the_assembled_tree(sliced):
    """``build_packed_engine`` over ``family_leaves`` with the expert
    stacks drawn in slices packs what ``from_quantised`` packs over the
    tree assembled from the same slices (codes and scales bit for bit, the
    same bits per parameter), and serves the same greedy tokens."""
    cfg = sliced
    eng, bits = build_packed_engine(
        cfg, SPEC, family_leaves(cfg, seed=SEED, device="cpu"),
        kv_len=KV_LEN, device="cpu")
    tree, names = assembled(cfg, SEED)
    assert names == EXPERTS
    params = map_with_paths(lambda n, _: tree[n],
                            transformer.param_specs(cfg))
    plan = build_plan(params, SPEC)
    assert bits == plan.bits_per_param(params)
    ref = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     kv_len=KV_LEN, device="cpu")
    got, want = dict(flat_with_paths(eng.params)), dict(
        flat_with_paths(ref.params))
    assert sorted(got) == sorted(want)
    for name, x in want.items():
        if isinstance(x, PackedTensor):
            assert torch.equal(got[name].codes, x.codes), name
            assert torch.equal(got[name].scales, x.scales), name
            assert got[name].shape == x.shape, name
        else:
            assert torch.equal(got[name], x), name
    assert greedy(eng, cfg.vocab) == greedy(ref, cfg.vocab)


def test_slices_take_the_whole_leafs_std(sliced):
    """Each slice is a truncated normal at the whole stacked leaf's
    fan-in (numel ÷ last dim), not its own: a (2, 4, 64, 128) stack has
    fan-in 512 (std 0.0442), a slice would have 256 (0.0625). The sample
    std of ±3σ draws is 0.98658σ; at 65,536 samples it lies within 1% of
    that. The leaves before the first sliced one are ``init``'s."""
    cfg = sliced
    tree, names = assembled(cfg, SEED)
    whole = dict(flat_with_paths(transformer.init(cfg, seed=SEED,
                                                  device="cpu")))
    for name in names:
        shape = tree[name].shape
        sigma = 1.0 / np.sqrt(np.prod(shape) // shape[-1])
        assert abs(float(tree[name].std()) / (0.98658 * sigma) - 1) < 0.01
    for name in sorted(tree)[:sorted(tree).index(names[0])]:
        assert torch.equal(tree[name], whole[name]), name


def test_sliced_leaf_reads_in_order_and_closes(sliced):
    """A sliced leaf gives the same slices when read again from slice 0,
    refuses a slice out of order and any read once the next leaf is
    drawn; the leaves after it do not depend on what the caller read."""
    cfg = sliced
    read_all, read_none, kept = {}, {}, {}
    for name, x in family_leaves(cfg, seed=SEED, device="cpu"):
        if isinstance(x, SlicedLeaf):
            first = list(x)
            assert all(torch.equal(a, b) for a, b in zip(first, x))
            with pytest.raises(IndexError):
                x[1]
            kept[name] = x
            x = torch.stack(first)
        read_all[name] = x
    for name, x in family_leaves(cfg, seed=SEED, device="cpu"):
        if not isinstance(x, SlicedLeaf):
            read_none[name] = x
    for name, x in kept.items():
        with pytest.raises(RuntimeError):
            x[0]
    for name, x in read_none.items():
        assert torch.equal(x, read_all[name]), name


def test_chunked_rows_pack_as_pack(sliced):
    """A packable leaf without lead dims (the embed, the unembed) quantised
    in chunks of rows packs the codes and scales of ``pack``."""
    cfg = sliced
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, SPEC)
    layouts = transformer.pack_layouts(cfg)
    monkey = plan_mod.PACK_CHUNK_ELEMS
    plan_mod.PACK_CHUNK_ELEMS = 1 << 28
    try:
        whole = dict(flat_with_paths(plan.pack(params, layouts)))
    finally:
        plan_mod.PACK_CHUNK_ELEMS = monkey
    for name in ("['embed']", "['unembed']"):
        x = dict(flat_with_paths(params))[name]
        assert x.numel() > SMOKE_CHUNK_ELEMS
        got = plan.pack_leaf(name, x, layouts)
        assert torch.equal(got.codes, whole[name].codes), name
        assert torch.equal(got.scales, whole[name].scales), name


# ---------------------------------------------------------------------------
# (c) the served models' weights stay bit for bit


@pytest.mark.parametrize("arch,variant", SERVED + [(ARCH, "full")])
def test_only_llama4_expert_stacks_cross_the_constant(arch, variant):
    """With the constant at its default (32 GiB), no leaf of a model
    served whole on the card is drawn in slices (their largest,
    internlm2-20b's and internvl2-26b's w_down, is 19.33 GB in f32), so
    their weights are ``init``'s bit for bit; llama4-scout's three expert
    stacks (128.85 GB each) are. Shapes only."""
    cfg = configs.get_config(arch, variant)
    specs = api.get_family(cfg.family).param_specs(cfg)
    crossing = [name for name, s in flat_with_paths(specs)
                if 4 * s.numel > api.SLICE_LEAF_BYTES]
    assert crossing == (EXPERTS if arch == ARCH else [])


# ---------------------------------------------------------------------------
# (d) the user's entry point


def test_serve_cli_serves_the_sliced_draw(sliced, capsys):
    """``launch.serve --packed`` at llama4 smoke, its expert stacks drawn
    in slices, serves the greedy tokens of the engine
    ``build_packed_engine`` makes from the same seed, and prints its
    weight bytes."""
    from repro_torch.launch import serve
    cfg = sliced
    done = serve.main(["--arch", ARCH, "--variant", "smoke", "--quantise",
                       SPEC, "--packed", "--kv-len", str(KV_LEN),
                       "--requests", "3", "--max-new", "5", "--seed",
                       str(SEED), "--no-dense-fallback", "--device", "cpu"])
    out = capsys.readouterr().out
    eng, _ = build_packed_engine(
        cfg, SPEC, family_leaves(cfg, seed=SEED, device="cpu"),
        kv_len=KV_LEN, device="cpu")
    assert {g.rid: g.tokens for g in done} == greedy(eng, cfg.vocab)
    wb = eng.weight_bytes()
    assert f"{wb['codes']:,} codes + {wb['scales']:,} scales" in out


# ---------------------------------------------------------------------------
# (e) chip_smoke.py's llama4 constants


def test_chip_smoke_constants_agree_with_the_config():
    """Launches a step (4 attention + 3 expert stacks + 3 shared
    projections a layer, and the unembed), the lead-dim launches (the
    three expert stacks a layer), the kernel rows' shapes and the hold's
    depth, from the config's widths and its pack layouts."""
    cfg = configs.get_config(ARCH, "full")
    layouts = transformer.pack_layouts(cfg)
    per_layer = sum(1 for name in layouts if name.startswith("['layers']"))
    lead = sum(1 for name, (n_lead, _) in layouts.items() if n_lead == 2)
    L = cfg.n_layers
    assert (per_layer, lead, L) == (10, 3, chip_smoke.LLAMA4_LAYERS)
    steps = chip_smoke.LAUNCHES_PER_STEP
    assert steps[ARCH] == {"dequant_matmul": per_layer * L + 1}
    assert steps[ARCH + " q8"] == {"dequant_matmul": per_layer * L + 1,
                                   "block_quant": L,
                                   "decode_attention_quant": L}
    H = chip_smoke.LLAMA4_HOLD_LAYERS
    assert H == 2
    assert steps[ARCH + " hold"] == {"dequant_matmul": per_layer * H + 1}
    assert chip_smoke.LLAMA4_LEAD_LAUNCHES == lead * L
    d, f = cfg.d_model, cfg.d_expert
    kv = cfg.n_kv_heads * cfg.head_dim
    assert [s for s, _, _ in chip_smoke.LLAMA4_PROJECTIONS] == [
        (d, cfg.n_heads * cfg.head_dim), (d, kv), (d, cfg.d_ff),
        (cfg.d_ff, d), (d, cfg.vocab)]
    experts = [(E, K, N, n) for m, E, K, N, n, _ in chip_smoke.EXPERT_CASES
               if m == ARCH]
    assert experts == [(cfg.n_experts, d, f, 2 * L),
                       (cfg.n_experts, f, d, L)]
    assert sum(n for _, n, _ in chip_smoke.LLAMA4_PROJECTIONS) + sum(
        n for *_, n in experts) == steps[ARCH]["dequant_matmul"]


@pytest.mark.parametrize("fault", ["code", "scale"])
def test_verify_reads_in_chunks(monkeypatch, fault):
    """``PackedTensor.verify`` reduces codes and scales a chunk at a time
    (an expert stack of llama4 full holds 16.1 GB of codes, whose unpacked
    copy would not fit beside the model): a code past the codebook or a
    non-finite scale in the last chunk is still found, with the
    reference's message."""
    from repro_torch.core import IntegrityError
    from repro_torch.core import tensor_format
    monkeypatch.setattr(tensor_format, "VERIFY_CHUNK_ELEMS", 100)
    cfg = configs.get_config(ARCH, "smoke")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, "babsmax64:n3")
    name = "['layers']['we_up']"
    w = plan.pack_leaf(name, dict(flat_with_paths(params))[name],
                       transformer.pack_layouts(cfg))
    assert w.bits == 4 and w.codes.numel() > 100
    w.verify(name)
    if fault == "code":
        w.codes.view(-1)[-1] = 0x80          # high nibble 8 of 8 points
        match = "code 8 out of codebook range"
    else:
        w.scales.view(-1)[-1] = float("nan")
        match = "non-finite block scales"
    with pytest.raises(IntegrityError, match=match):
        w.verify(name)
