"""The port's boundaries: it never imports JAX or the reference package,
its entry points run on the card unless asked for the CPU, and a kernel call
is decided by where its tensors lie — never by a fallback."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro_torch.models import transformer
from repro_torch.models.api import resolve_device
from repro_torch.serve.engine import ServeEngine, greedy_generate

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_or_jax_imports(path):
    assert path.exists(), path
    bad = [(line, mod) for line, mod in imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_port_imports_without_jax_loaded():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve,"
            " repro_torch.launch.train, repro_torch.train, repro_torch.data,"
            " repro_torch.core, repro_torch.interop,"
            " repro_torch.serve.scheduler, repro_torch.serve.traffic,"
            " repro_torch.serve.faults, repro_torch.train.compressed_ckpt; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_model_families_import_without_jax_loaded():
    code = ("import sys, repro_torch.models.whisper, "
            "repro_torch.models.internvl, repro_torch.models.rwkv6, "
            "repro_torch.models.zamba2, repro_torch.configs, "
            "repro_torch.configs.shapes, repro_torch.data.pipeline; "
            "from repro_torch.models.api import get_family; "
            "[get_family(n) for n in ('whisper', 'internvl', 'rwkv6', "
            "'zamba2')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_is_lint_clean_without_pragmas():
    """The reference's lint gate walks all of src/, the port included."""
    r = subprocess.run([sys.executable, "-m", "repro.analysis",
                        str(PORT), "--no-contracts"], cwd=REPO,
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert not [p for p in PORT.rglob("*.py")
                if "lint: allow" in p.read_text()]


# ---------------------------------------------------------------------------
# Entry points default to the card


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")


def test_resolve_device_refuses_the_default_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_device(no_card):
    cfg = configs.get_config("paper-100m", "smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(cfg)
    params = transformer.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_generate(cfg, params, np.zeros((1, 2), np.int64), 1)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_serve_cli_defaults_to_the_card(no_card):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--variant", "smoke"])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_cli_of_the_new_families_defaults_to_the_card(no_card, arch):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--variant", "smoke", "--quantise",
                    "babsmax64:n4", "--packed"])


def test_serve_cli_traffic_replay_defaults_to_the_card(no_card):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--variant", "smoke", "--traffic-replay", "0",
                    "--requests", "2"])


def test_train_cli_defaults_to_the_card(no_card, tmp_path):
    from repro_torch.launch import train as train_cli
    from repro_torch.train import loop, optimizer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--variant", "smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())         # nothing ran, nothing saved
    cfg = configs.get_config("paper-100m", "smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, loop.TrainConfig(steps=1), optimizer.AdamConfig(),
                   lambda s: {})


# ---------------------------------------------------------------------------
# Dispatch by device


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (32, 128)).astype(np.uint8))
    scales = torch.ones(64, 2, dtype=torch.bfloat16)
    cb = torch.linspace(-1, 1, 16)
    before = dqm.launches
    y = ops.dequant_matmul(x, codes, scales, cb, block=64, bits=4)
    assert dqm.launches == before
    assert torch.equal(y, dequant_matmul_ref(x, codes, scales, cb, 64, 4))


def test_cuda_wrapper_refuses_cpu_tensors(monkeypatch):
    """The kernel's wrapper never computes on the CPU: with the library
    stubbed in, CPU operands are refused, not served by the plain path."""
    monkeypatch.setattr(dqm.build, "load_library", lambda name: object())
    x = torch.zeros(2, 64)
    codes = torch.zeros(32, 128, dtype=torch.uint8)
    scales = torch.ones(64, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        dqm.dequant_matmul_cuda(x, codes, scales, torch.zeros(16), 64, 4)
