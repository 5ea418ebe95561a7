"""Native (C++) components, loaded via ctypes with pure-Python fallbacks.

Built lazily with ``g++`` into a per-version cache; every native function has a
Python twin that is also the correctness oracle in tests.  Set
``MIMIC_TPU_NO_NATIVE=1`` to force the Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional

_SRCS = [
    os.path.join(os.path.dirname(__file__), "ptb_tokenizer.cpp"),
    os.path.join(os.path.dirname(__file__), "image_ops.cpp"),
]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MIMIC_TPU_NO_NATIVE"):
        return None
    try:
        h = hashlib.sha256()
        for src in _SRCS:
            with open(src, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        cache_dir = os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "mimic_tpu_torch",
        )
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"mimic_native-{digest}.so")
        if not os.path.exists(so_path):
            tmp = f"{so_path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, *_SRCS],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.ptb_tokenize_line.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.ptb_tokenize_line.restype = ctypes.c_int
        u8 = ctypes.POINTER(ctypes.c_uint8)
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.resize_u8.argtypes = [
            u8, ctypes.c_int, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.resize_u8.restype = ctypes.c_int
        lib.resize_normalize_f32.argtypes = [
            u8, ctypes.c_int, ctypes.c_int, f32, ctypes.c_int, ctypes.c_int,
            f32, f32,
        ]
        lib.resize_normalize_f32.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def ptb_tokenize_native(line: str, lowercase: bool = True) -> Optional[List[str]]:
    """C++ PTB tokenization; None when the native library is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    data = line.encode("utf-8")
    cap = max(256, 2 * len(data) + 64)
    buf = ctypes.create_string_buffer(cap)
    n = lib.ptb_tokenize_line(data, 1 if lowercase else 0, buf, cap)
    if n < 0:
        cap = 8 * len(data) + 1024
        buf = ctypes.create_string_buffer(cap)
        n = lib.ptb_tokenize_line(data, 1 if lowercase else 0, buf, cap)
        if n < 0:
            return None
    out = buf.value.decode("utf-8", errors="replace")
    return out.split(" ") if out else []


def resize_native(arr, h: int, w: int, resample: str = "bilinear"):
    """PIL-exact uint8 RGB resize in C++; None when unavailable.

    ``arr``: [H,W,3] uint8 C-contiguous numpy array → [h,w,3] uint8.
    ``resample``: "bilinear" or "bicubic" — bit-identical to
    ``PIL.Image.resize((w, h), Image.<RESAMPLE>)`` (the Python path is the
    oracle, see tests/test_native_image_ops.py).
    """
    lib = _build_and_load()
    if lib is None:
        return None
    import numpy as np

    mode = {"bilinear": 0, "bicubic": 1}.get(resample)
    if mode is None:
        return None
    src = np.ascontiguousarray(arr, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        return None
    dst = np.empty((h, w, 3), np.uint8)
    rc = lib.resize_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.shape[0], src.shape[1],
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, mode,
    )
    return dst if rc == 0 else None


def resize_bilinear_native(arr, h: int, w: int):
    return resize_native(arr, h, w, "bilinear")
