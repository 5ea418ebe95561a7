"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

The sources are compiled on first use into ``ops/build/`` (git-ignored), as
one shared library with a plain C interface, for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libmimic_attn-<hash>.so csrc/*.cu

The file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at import
time: the CPU test suite imports every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_fwd.cu", "onepass_fwd.cu")
HEADERS = ("attn_common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((*ARCH_FLAGS, *NVCC_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Dict[str, object]:
    """Compile the kernels unless an up-to-date library exists.

    Returns a dict with the library ``path``, the ``seconds`` spent compiling
    and the nvcc ``command`` (0 and "" when the library was up to date).
    """
    path = BUILD_DIR / f"libmimic_attn-{_digest()}.so"
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "command": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
        *(str(CSRC / s) for s in SOURCES),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "command": " ".join(cmd)}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("mimic_flash_fwd", "mimic_onepass_fwd"):
        fn = getattr(lib, name)
        # q, k, v, key_mask, out, lse, lse_u, B, T, S, H, Hkv, D, dtype, scale,
        # causal, need_unmasked, stream
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    lib.mimic_cuda_error_string.argtypes = [i]
    lib.mimic_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
