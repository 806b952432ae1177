"""Build and load the port's CUDA kernel libraries.

Every source in ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library of its own with a plain C interface, loaded with ``ctypes``.
The sources are compiled in parallel, one ``nvcc`` each, all started
together. The build directory is keyed by a hash of all sources and the
flags, lives inside the package (``kernels/_build/``, ignored by git) and is
filled at first use, so a fresh checkout builds on its first kernel call.
Nothing is built or loaded when the module is imported.

No ``--use_fast_math``: f32 ``/`` stays IEEE-rounded, which ``block_quant``
needs for codes that equal the plain version's bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
CSRC = KERNELS_DIR / "csrc"
BUILD_ROOT = KERNELS_DIR / "_build"
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {its C functions: their argument types}
SIGNATURES = {
    "dequant_matmul": {"dequant_matmul_launch": [_P] * 8 + [_I] * 11 + [_P]},
    "dequant_matmul_t": {
        "dequant_matmul_t_launch": [_P] * 6 + [_I] * 11 + [_P]},
    "block_quant": {"block_quant_launch": [_P] * 8 + [_I] * 8 + [_P],
                    "block_quant_floor_launch": [_P]},
    "decode_attention": {
        "decode_attention_quant_launch": [_P] * 8 + [_I] * 15 + [_F, _P],
        "decode_attention_instance_info": [_I] * 7 + [_P]},
}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "CUDA kernels cannot be built")
    return nvcc


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SIGNATURES):
        h.update(name.encode() + source(name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(verbose: bool = False) -> dict:
    """Compile every library whose build does not exist yet, in parallel;
    return ``{name: path}``.

    ``verbose`` compiles all of them with ``-Xptxas -v`` even if their
    builds exist, and keeps nvcc's report (registers, shared memory and
    spills of each kernel) in ``ptxas_<name>.txt`` beside the library."""
    paths = {name: library_path(name) for name in SIGNATURES}
    todo = [n for n, p in paths.items() if verbose or not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-o", tmp, str(source(name))]
            jobs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}:\n"
                              f"{report}")
                continue
            if verbose:
                (out_dir / f"ptxas_{name}.txt").write_text(report)
            os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("CUDA build failed\n" + "\n".join(failed))
    finally:
        for tmp, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build if needed and load one library, with its C signatures set."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; the kernel runs only on "
                           "the card")
    lib = ctypes.CDLL(str(build()[name]))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
