"""Parameter bridge: the JAX param pytree (numpy leaves) ↔ the port's torch tree.

Both packages keep parameters as nested dicts of stacked ``[L, ...]`` arrays
with the same keys, so the bridge is a tree map with a dtype map.  bfloat16
crosses as its uint16 bit pattern (``ndarray.view`` / ``Tensor.view``), so this
module needs nothing beyond numpy and torch: the JAX side's bfloat16 numpy
dtype is recognised by name and, on the way back, supplied by the caller.

    tree_t = to_torch(jax.tree.map(np.asarray, params), device="cpu")
    back = to_numpy(tree_t, bfloat16=jnp.bfloat16)   # bit-exact round trip
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .device import DeviceLike, resolve_device

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _leaf_to_torch(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    # np.array(order="C") keeps 0-d leaves 0-d (np.ascontiguousarray makes them 1-d)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(device)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"no torch dtype for numpy dtype {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _leaf_to_numpy(t: torch.Tensor, bfloat16: Optional[Any]) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16).copy()
        return bits.view(bfloat16) if bfloat16 is not None else bits
    if t.dtype not in _TORCH_TO_NP:
        raise TypeError(f"no numpy dtype for torch dtype {t.dtype}")
    return t.numpy().copy()


def to_torch(tree: Any, device: DeviceLike) -> Any:
    """numpy-leaf tree (e.g. a JAX pytree after ``np.asarray``) → torch tree."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev), tree)


def to_numpy(tree: Any, bfloat16: Optional[Any] = None) -> Any:
    """torch tree → numpy-leaf tree.

    ``bfloat16``: the numpy bfloat16 dtype to give bf16 leaves (JAX's
    ``jnp.bfloat16``); without it they come back as their uint16 bit patterns.
    """
    return tree_map(lambda t: _leaf_to_numpy(t, bfloat16), tree)


class ParamModule(nn.Module):
    """A thin ``nn.Module`` holding a parameter tree as buffers, so that
    ``.to(device)`` / ``.to(dtype)`` move the whole tree; ``tree()`` rebuilds
    the nested dict of (moved) tensors."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._paths = []
        self._add(tree, ())

    def _add(self, node: Any, path: tuple) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                self._add(v, path + (k,))
            return
        name = "/".join(path)
        self.register_buffer(name, node)
        self._paths.append(path)

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for path in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._buffers["/".join(path)]
        return out
