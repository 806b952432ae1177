"""Tests for repro_torch.analysis: the port's lint rules against its torch
fixture corpus (``tests/lint_fixtures_torch``), the engine's pragmas,
syntax errors and baselines held to the reference's ``repro.analysis.lint``
on the same strings, the contract verifier held to the reference's on the
same configs (plus injected violations), and the CLI gate: clean on
``src/repro_torch``, red on violations staged in a temporary
``src/repro_torch/serve/`` (never under this repo's ``src/``, which the
reference's gate lints from another worker)."""
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import contracts as jcontracts
from repro.analysis import lint as jlint

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.lint import Finding, lint_file, partition
from repro_torch.analysis.rules import RULE_IDS

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "lint_fixtures_torch"
_EXPECT = re.compile(r"#\s*EXPECT:\s*([a-z][a-z0-9\-]*)")

VIOLATION_FILES = sorted(FIXTURES.glob("*_violation.py"))
CLEAN_FILES = sorted(FIXTURES.glob("*_clean.py"))


def expected_findings(path: Path):
    """(rule_id, line) pairs declared by ``# EXPECT:`` trailing markers."""
    out = []
    for i, text in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT.search(text)
        if m:
            out.append((m.group(1), i))
    return sorted(out)


def run_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(cwd)})


# ---------------------------------------------------------------------------
# Lint rules vs the torch fixture corpus
# ---------------------------------------------------------------------------

def test_corpus_is_paired():
    """Every rule has a violation file and a clean twin."""
    stems = {p.stem for p in FIXTURES.glob("*.py")}
    for rid in RULE_IDS:
        base = rid.replace("-", "_")
        assert f"{base}_violation" in stems, rid
        assert f"{base}_clean" in stems, rid


@pytest.mark.parametrize("path", VIOLATION_FILES, ids=lambda p: p.stem)
def test_violations_hit_exact_rule_and_line(path):
    want = expected_findings(path)
    assert want, f"{path.name} declares no EXPECT markers"
    got = sorted((f.rule, f.line) for f in lint_file(str(path)))
    assert got == want


@pytest.mark.parametrize("path", CLEAN_FILES, ids=lambda p: p.stem)
def test_clean_twins_have_zero_findings(path):
    assert lint_file(str(path)) == []


def test_rule_ids_are_the_reference_ids():
    from repro.analysis.rules import RULE_IDS as JRULE_IDS
    assert RULE_IDS == JRULE_IDS


@pytest.mark.parametrize("src,path,rules", [
    # the wall clock counts only in step paths of the package
    ("import time\nt = time.time()\n", "src/repro_torch/serve/x.py",
     ["nondeterminism"]),
    ("import time\nt = time.time()\n", "src/repro_torch/train/x.py", []),
    ("import time\nt = time.time()\n", "src/repro/serve/x.py",
     ["nondeterminism"]),
    # the API's own bodies contract weights
    ("def linear(x, lp):\n    return x @ lp['wq']\n", "m.py", []),
    ("def proj(x, lp):\n    return x @ lp['wq']\n", "m.py",
     ["raw-weight-einsum"]),
])
def test_rule_scoping(tmp_path, src, path, rules):
    f = tmp_path / path
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    got = lint_mod.lint_file(str(f))
    assert [x.rule for x in got] == rules


def test_in_repo_src_keys_on_the_port():
    from repro_torch.analysis.rules import in_repo_src
    assert in_repo_src("src/repro_torch/serve/engine.py")
    assert not in_repo_src("src/repro/serve/engine.py")


# ---------------------------------------------------------------------------
# The engine held to the reference's on the same strings
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "pragma_with_reason": (
        "import numpy as np\n"
        "x = np.random.normal()  # lint: allow(nondeterminism) demo jitter\n"),
    "pragma_on_line_above": (
        "import numpy as np\n"
        "# lint: allow(nondeterminism) demo jitter\n"
        "x = np.random.normal()\n"),
    "pragma_two_lines_above": (
        "import numpy as np\n"
        "# lint: allow(nondeterminism) demo jitter\n"
        "\n"
        "x = np.random.normal()\n"),
    "reasonless_pragma": (
        "import numpy as np\n"
        "x = np.random.normal()  # lint: allow(nondeterminism)\n"),
    "unknown_rule_id": "x = 1  # lint: allow(no-such-rule) because reasons\n",
    "two_ids_one_unknown": (
        "import random\n"
        "y = random.random()  # lint: allow(nondeterminism, bogus) why\n"),
    "pragma_without_space": (
        "import random\n"
        "y = random.random()  # lint:allow(nondeterminism) seeded upstream\n"),
    "docstring_pragma_inert": (
        '"""Write # lint: allow(no-such-rule) to suppress."""\n'
        's = "# lint: allow(nondeterminism)"\n'),
    "syntax_error": "def broken(:\n",
    "stdlib_and_legacy": (
        "import random\nimport numpy as np\n"
        "a = random.choice([1, 2])\nnp.random.seed(0)\n"),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_matches_the_reference(tmp_path, name):
    """The same file through both engines: the same (line, rule) findings,
    and the same messages for the engine's own ``bad-pragma`` and
    ``syntax-error`` findings."""
    f = tmp_path / "snippet.py"
    f.write_text(ENGINE_CASES[name])
    got, want = lint_file(str(f)), jlint.lint_file(str(f))
    assert [(x.path, x.line, x.rule) for x in got] == \
        [(x.path, x.line, x.rule) for x in want]
    assert [x.message for x in got if x.rule in ("bad-pragma",
                                                  "syntax-error")] == \
        [x.message for x in want if x.rule in ("bad-pragma",
                                               "syntax-error")]


@pytest.mark.parametrize("base_line,rule,path,baselined", [
    (12, "nondeterminism", "a.py", True),      # drift of 2 tolerated
    (8, "nondeterminism", "a.py", True),
    (13, "nondeterminism", "a.py", False),     # drift of 3 is not
    (10, "host-aliasing", "a.py", False),      # another rule
    (10, "nondeterminism", "b.py", False),     # another file
])
def test_partition_matches_the_reference(base_line, rule, path, baselined):
    base = [{"rule": rule, "path": path, "line": base_line}]
    new, old = partition([Finding("a.py", 10, "nondeterminism", "m")], base)
    jnew, jold = jlint.partition(
        [jlint.Finding("a.py", 10, "nondeterminism", "m")], base)
    assert (len(new), len(old)) == (len(jnew), len(jold))
    assert bool(old) == baselined


def test_baseline_files_read_alike(tmp_path):
    """A baseline written by either package loads in the other."""
    f = tmp_path / "snippet.py"
    f.write_text(ENGINE_CASES["stdlib_and_legacy"])
    lint_mod.save_baseline(lint_file(str(f)), tmp_path / "port.json")
    jlint.save_baseline(jlint.lint_file(str(f)), tmp_path / "ref.json")
    assert lint_mod.load_baseline(tmp_path / "ref.json") == \
        jlint.load_baseline(tmp_path / "port.json")
    assert lint_mod.load_baseline(tmp_path / "missing.json") == []


def test_checked_in_baseline_is_empty():
    assert json.loads(lint_mod.DEFAULT_BASELINE.read_text()) == []
    assert lint_mod.DEFAULT_BASELINE.parent.name == "analysis"
    assert "repro_torch" in lint_mod.DEFAULT_BASELINE.parts


# ---------------------------------------------------------------------------
# The CLI in process: baselines, rules, unknown families
# ---------------------------------------------------------------------------

def test_baselined_findings_do_not_fail_the_cli(tmp_path, capsys):
    target = FIXTURES / "nondeterminism_violation.py"
    bl = tmp_path / "baseline.json"
    lint_mod.save_baseline(lint_file(str(target)), bl)
    assert cli.main([str(target), "--no-contracts", "--baseline",
                     str(bl)]) == 0
    assert "baselined finding(s) suppressed" in capsys.readouterr().out
    assert cli.main([str(target), "--no-contracts"]) == 1
    out = capsys.readouterr().out
    assert "[nondeterminism]" in out and "lint FAILED" in out


def test_write_baseline_accepts_the_findings(tmp_path, capsys):
    target = FIXTURES / "host_aliasing_violation.py"
    bl = tmp_path / "baseline.json"
    assert cli.main([str(target), "--no-contracts", "--baseline", str(bl),
                     "--write-baseline"]) == 0
    assert len(lint_mod.load_baseline(bl)) == \
        len(expected_findings(target))


def test_rules_are_listed(capsys):
    assert cli.main(["--rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULE_IDS:
        assert rid in out


def test_unknown_family_tag_exits_2(capsys):
    assert cli.main(["--contracts-only", "--family", "no-such-arch"]) == 2
    assert "no-such-arch" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The gate (two subprocesses)
# ---------------------------------------------------------------------------

def test_port_is_clean_under_its_own_gate():
    """``python -m repro_torch.analysis src/repro_torch``: lint OK with the
    empty baseline, contracts OK for all 11 smoke configs, covering every
    registered family."""
    from repro_torch.models import api as mapi
    r = run_cli("src/repro_torch")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint OK — 0 new finding(s) (0 baselined" in r.stdout
    m = re.search(r"contracts OK — (\d+) config\(s\) over families "
                  r"\[(.*)\]", r.stdout)
    assert m, r.stdout
    assert int(m.group(1)) == 11
    mapi.get_family("transformer")
    assert set(re.findall(r"'([a-z0-9]+)'", m.group(2))) == \
        set(mapi._FAMILIES)


def test_violation_staged_in_a_port_tree_fails_the_gate(tmp_path):
    """Every fixture violation copied into a temporary
    ``src/repro_torch/serve/`` turns the gate red, naming rule id and
    ``file:line`` — path scoping sees a port path (the wall-clock check
    included)."""
    serve = tmp_path / "src" / "repro_torch" / "serve"
    serve.mkdir(parents=True)
    staged = [(p, serve / f"_lintcheck_{p.name}") for p in VIOLATION_FILES]
    for src_f, dst in staged:
        shutil.copy(src_f, dst)
    r = run_cli("src/repro_torch", "--no-contracts", cwd=tmp_path)
    assert r.returncode == 1, r.stdout + r.stderr
    for src_f, dst in staged:
        for rid, line in expected_findings(src_f):
            assert f"src/repro_torch/serve/{dst.name}:{line}: [{rid}]" \
                in r.stdout, (dst.name, rid, line)
    assert "lint FAILED" in r.stdout


# ---------------------------------------------------------------------------
# host_to_device (the sanctioned escape of host-aliasing)
# ---------------------------------------------------------------------------

def test_host_to_device_snapshots_against_later_host_mutation():
    from repro_torch.serve.engine import host_to_device
    buf = np.arange(4, dtype=np.int32)
    dev = host_to_device(buf, "cpu")
    buf[:] = -1
    assert dev.tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# Registry contract verifier, held to the reference's
# ---------------------------------------------------------------------------

def config_pair(tag):
    from repro import configs as jconfigs
    from repro_torch import configs
    return (configs.get_config(tag, "smoke"),
            jconfigs.get_config(tag, "smoke"))


@pytest.mark.parametrize("tag", ["paper-100m", "gemma3-1b", "rwkv6-1.6b"])
def test_contracts_agree_with_the_reference(tag):
    cfg, jcfg = config_pair(tag)
    got = contracts_mod.verify_family(tag, cfg)
    want = jcontracts.verify_family(tag, jcfg)
    assert (got.ok, len(got.findings), got.family) == \
        (want.ok, len(want.findings), want.family)


def broken_family(monkeypatch, api, **fields):
    fam = api.get_family("transformer")
    monkeypatch.setitem(api._FAMILIES, "transformer",
                        dataclasses.replace(fam, **fields))
    return fam


def test_broken_pack_layouts_is_caught(monkeypatch):
    from repro.models import api as japi
    from repro_torch.models import api as mapi
    ghost = {"['layers']['w_ghost']": (1, 1)}
    for api in (mapi, japi):
        broken_family(monkeypatch, api, pack_layouts=lambda cfg: ghost)
    cfg, jcfg = config_pair("paper-100m")
    rep = contracts_mod.verify_family("paper-100m", cfg)
    jrep = jcontracts.verify_family("paper-100m", jcfg)
    assert not rep.ok
    assert any("w_ghost" in f.message for f in rep.findings)
    assert len(rep.findings) == len(jrep.findings)


def test_missing_pos_spec_is_caught(monkeypatch):
    from repro.models import api as japi
    from repro_torch.models import api as mapi
    for api in (mapi, japi):
        orig = api.get_family("transformer").decode_state_specs
        broken_family(monkeypatch, api, decode_state_specs=(
            lambda orig: lambda *a, **k: {
                k2: v for k2, v in orig(*a, **k).items() if k2 != "pos"})(
                    orig))
    cfg, jcfg = config_pair("paper-100m")
    rep = contracts_mod.verify_family("paper-100m", cfg)
    jrep = jcontracts.verify_family("paper-100m", jcfg)
    assert any("pos" in f.message for f in rep.findings)
    assert rep.ok == jrep.ok and not rep.ok


def test_uncovered_family_is_a_registry_finding(monkeypatch):
    """A registered family no config reaches is a finding of its own
    (``verify_family`` is stubbed: only the coverage check runs here)."""
    from repro_torch.models import api as mapi
    fam = mapi.get_family("transformer")
    monkeypatch.setitem(mapi._FAMILIES, "ghost-family",
                        dataclasses.replace(fam, name="ghost-family"))
    monkeypatch.setattr(contracts_mod, "verify_family",
                        lambda tag, cfg: contracts_mod.ContractReport(
                            tag, cfg.family, ()))
    reports = contracts_mod.verify_all()
    reg = [r for r in reports if r.tag == "registry"]
    assert reg and not reg[0].ok and reg[0].family == "ghost-family"
    assert len(reports) == 12


def test_a_step_that_reads_a_value_is_reported(monkeypatch):
    """``decode_step`` runs on meta tensors: a step that reads a value
    (``.item()``) cannot, and the contract says which call it refused."""
    from repro_torch.models import api as mapi
    fam = mapi.get_family("transformer")
    step = fam.decode_step

    def reads(params, state, batch, cfg):
        int(batch["tokens"].max().item())
        return step(params, state, batch, cfg)
    broken_family(monkeypatch, mapi, decode_step=reads)
    cfg, _ = config_pair("paper-100m")
    rep = contracts_mod.verify_family("paper-100m", cfg)
    assert not rep.ok
    assert any("ragged (B, 4) chunk" in f.message for f in rep.findings)
