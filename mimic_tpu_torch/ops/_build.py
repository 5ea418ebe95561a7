"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

The sources are compiled on first use into ``ops/build/`` (git-ignored), as
one shared library with a plain C interface, for ``sm_90a``.  Each source is
compiled to an object by its own ``nvcc``, all started together, then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -lineinfo -Xptxas=-v -c -o build/<hash>/<name>.o csrc/<name>.cu   # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/libmimic_kernels-<hash>.so build/<hash>/*.o

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
SOURCES = (
    "flash_fwd.cu", "onepass_fwd.cu", "flash_bwd.cu",
    "int8_matmul.cu", "fused_mlp_int8.cu", "prompt_attn_int8.cu", "w8a8_matmul.cu",
)
HEADERS = ("attn_common.cuh", "attn_mma.cuh", "attn_wgmma_ops.cuh", "attn_bwd_mma.cuh",
           "int8_common.cuh", "int8_mma.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

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


def _check(proc: subprocess.CompletedProcess, cmd) -> None:
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )


def build() -> Dict[str, object]:
    """Compile the kernels unless an up-to-date library exists.

    Returns a dict with the library ``path``, the ``seconds`` spent compiling,
    the nvcc ``command`` lines and ``ptxas``, what ``-Xptxas=-v`` said of each
    kernel's registers, spills and shared memory (0 and "" when the library
    was up to date).
    """
    digest = _digest()
    path = BUILD_DIR / f"libmimic_kernels-{digest}.so"
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "command": "", "ptxas": ""}
    obj_dir = BUILD_DIR / f"{digest}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    compiles, ptxas = [], []
    for src in SOURCES:
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o",
               str(obj_dir / (Path(src).stem + ".o")), str(CSRC / src)]
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
    for cmd, p in compiles:
        out, err = p.communicate()
        _check(subprocess.CompletedProcess(cmd, p.returncode, out, err), cmd)
        ptxas.append(err)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *(str(obj_dir / (Path(s).stem + ".o")) for s in SOURCES)]
    _check(subprocess.run(link, capture_output=True, text=True), link)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    command = "\n".join(" ".join(c) for c in [*(c for c, _ in compiles), link])
    return {"path": str(path), "seconds": seconds, "command": command, "ptxas": "".join(ptxas)}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("mimic_flash_fwd", "mimic_onepass_fwd"):
        fn = getattr(lib, name)
        # q, k, v, key_mask, out, lse, lse_u, B, T, S, H, Hkv, D, dtype, scale,
        # causal, need_unmasked, stream
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, p]
        fn.restype = i
    # D, then out: query rows per CTA, rows per warpgroup, keys per tile
    lib.mimic_attn_fwd_tiling.argtypes = [i] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mimic_attn_fwd_tiling.restype = i
    # q, k, v, g_out, key_mask, lse, lse_u, delta, g_lse, g_lse_u, dq,
    # B, T, S, H, Hkv, D, dtype, scale, causal, need_unmasked, stream
    lib.mimic_flash_bwd_dq.argtypes = [p] * 11 + [i] * 7 + [f, i, i, p]
    lib.mimic_flash_bwd_dq.restype = i
    # the same with dk, dv in place of dq, and the cluster split before the stream
    lib.mimic_flash_bwd_dkv.argtypes = [p] * 12 + [i] * 7 + [f, i, i, i, p]
    lib.mimic_flash_bwd_dkv.restype = i
    # out: dq rows per CTA, dq keys per tile, dkv keys per CTA, dkv rows per tile, max split
    lib.mimic_flash_bwd_tiling.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    lib.mimic_flash_bwd_tiling.restype = i
    lib.mimic_int8_matmul_ksplit.argtypes = [i, i, i]
    lib.mimic_int8_matmul_ksplit.restype = i
    # x, w, scale, work, out, M, K, N, ksplit, out_dtype, stream
    lib.mimic_int8_matmul.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.mimic_int8_matmul.restype = i
    # x, ldx, w, scale, out, M, K, N, ksplit, out_dtype, stream
    lib.mimic_int8_matmul_mma.argtypes = [p, i, p, p, p] + [i] * 5 + [p]
    lib.mimic_int8_matmul_mma.restype = i
    # xn, gu, gu_scale, down, down_scale, work, out, M, D, F, out_dtype, stream
    lib.mimic_fused_mlp_int8.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.mimic_fused_mlp_int8.restype = i
    # xn, gu, gu_scale, down, down_scale, h, out, M, D, F, ks_gu, ks_down, out_dtype, stream
    lib.mimic_fused_mlp_int8_mma.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.mimic_fused_mlp_int8_mma.restype = i
    # q, k8, ks, v8, vs, mask, work, o, m, l, B0, Hkv, M, Sp, dtype, stream
    lib.mimic_prompt_attn_int8.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.mimic_prompt_attn_int8.restype = i
    # x8, xs, w, sw, out, M, K, N, out_dtype, stream
    lib.mimic_w8a8_matmul.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.mimic_w8a8_matmul.restype = i
    lib.mimic_cuda_error_string.argtypes = [i]
    lib.mimic_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
