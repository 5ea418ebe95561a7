"""Row norms: LayerNorm and RMSNorm over the last axis.

Counterpart of ``mimic_tpu/models/layers.py::layer_norm`` and ``::rms_norm``,
which XLA fuses into one pass over the rows on the TPU.  ``layer_norm_plain``
and ``rms_norm_plain`` are the port's plain PyTorch versions: the functions of
``models/layers.py`` under the JAX names, which the decoder and every CPU path
run, differentiable and on any device.

One hand-written CUDA kernel (``csrc/row_norm.cu``, built by ``_build.py``)
serves both norms: one read of the rows and one write, the statistics and the
affine in fp32 and one rounding to the rows' type.  ``layer_norm`` and
``rms_norm`` launch it for a CUDA tensor, or raise, and take the plain version
for a CPU tensor.  The kernel has no backward: a CUDA input that requires grad
under grad mode raises, and a caller that needs the gradient calls the plain
version (``models/vision.py`` decides by ``needs_grad``).

``LAUNCHES`` counts the kernel's launches by norm; each launch also counts
``norm_kernel_launches`` in the program's recorder (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..models.layers import layer_norm as layer_norm_plain
from ..models.layers import rms_norm as rms_norm_plain
from ..utils.tracing import count
from .quant import _KERNEL_DTYPES, _no_device, _raise_on_error

LAUNCHES: Dict[str, int] = {"layer_norm": 0, "rms_norm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on ``tensors`` (None entries skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def kernel_plan(D: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The kernel's row mapping at width ``D``: (lanes a row, 16-byte vectors a
    lane), from ``csrc/row_norm.cu``; ValueError where it does not take ``D``."""
    from . import _build

    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"row_norm: rows must be one of {list(_KERNEL_DTYPES)}, got {dtype}")
    lanes, vectors = ctypes.c_int(), ctypes.c_int()
    if _build.load_library().mimic_row_norm_plan(D, _KERNEL_DTYPES[dtype], ctypes.byref(lanes),
                                                 ctypes.byref(vectors)):
        per_vector = 128 // torch.finfo(dtype).bits
        raise ValueError(f"row_norm: no kernel for width {D} in {dtype} (a multiple of "
                         f"{per_vector} up to {32 * 32 * per_vector})")
    return lanes.value, vectors.value


def _launch(name: str, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    from . import _build

    if needs_grad(x, weight, bias):
        raise ValueError(f"{name}: the kernel has no backward; call {name}_plain where a "
                         "gradient is needed")
    affine = [t for t in (weight, bias) if t is not None]
    if x.dtype not in _KERNEL_DTYPES or weight.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: rows and weights must be one of {list(_KERNEL_DTYPES)}, got "
                        f"{x.dtype} / {weight.dtype}")
    if bias is not None and bias.dtype != weight.dtype:
        raise TypeError(f"{name}: bias {bias.dtype} and weight {weight.dtype} differ")
    D = x.shape[-1] if x.dim() else 0
    for t in (x, *affine):
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.shape != (D,) for t in affine):
        raise ValueError(f"{name}: weight and bias must be [{D}], got "
                         f"{[tuple(t.shape) for t in affine]}")
    kernel_plan(D, x.dtype)
    # a lane reads 16 bytes of x, and E (16 / x's element size) elements of w and b
    per_vector = 16 // x.element_size()
    if x.data_ptr() % 16 or any(t.data_ptr() % min(16, per_vector * t.element_size())
                                for t in affine):
        raise ValueError(f"{name}: rows must start 16-byte aligned and weights on a whole vector")
    y = torch.empty_like(x)
    M = x.numel() // D
    if M == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.mimic_row_norm(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), M, D, _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[weight.dtype],
            int(name == "rms_norm"), eps, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    count("norm_kernel_launches")
    return y


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """LayerNorm over the last axis: the one-pass kernel on CUDA (no backward), the
    plain version on the CPU."""
    if x.device.type == "cuda":
        return _launch("layer_norm", x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    raise _no_device("layer_norm", x)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis: the one-pass kernel on CUDA (no backward), the
    plain version on the CPU."""
    if x.device.type == "cuda":
        return _launch("rms_norm", x, weight, None, eps)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    raise _no_device("rms_norm", x)
