"""Build and load the CUDA ``dequant_matmul`` library.

``nvcc`` compiles ``kernels/csrc/dequant_matmul.cu`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
directory is keyed by a hash of the source and the flags, lives inside the
package (``kernels/_build/``, ignored by git) and is filled at first use,
so a fresh checkout builds on its first call. Nothing is built or loaded
when the module is imported.
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

KERNELS_DIR = Path(__file__).resolve().parents[1]
SOURCE = KERNELS_DIR / "csrc" / "dequant_matmul.cu"
BUILD_ROOT = KERNELS_DIR / "_build"
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise RuntimeError("dequant_matmul: nvcc not found (PATH or "
                           "/usr/local/cuda/bin); the CUDA kernel cannot be "
                           "built")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / "libdequant_matmul.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless this source's build exists; return it.

    ``verbose`` compiles with ``-Xptxas -v`` even if the build exists and
    keeps nvcc's report (registers, shared memory and spills of each
    kernel) in ``ptxas.txt`` beside the library."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        if verbose:
            (out.parent / "ptxas.txt").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the library, with its C signatures set."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("dequant_matmul: no CUDA device; the kernel runs "
                           "only on the card")
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dequant_matmul_launch.argtypes = [p, p, p, p, p, p] + [i] * 10 + [p]
    lib.dequant_matmul_launch.restype = i
    return lib
