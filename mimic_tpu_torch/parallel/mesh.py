"""Device mesh and sharding rules over ``torch.distributed``.

Counterpart of ``mimic_tpu/parallel/mesh.py``.  One process per card; the
process group's world is laid out as a ``DeviceMesh`` named ``("data",
"model")``.  Parameters follow the JAX package's key-path rules: the matched
dimension of a leaf is split over ``model`` (tensor parallel), everything else
is replicated; batches are split over ``data`` on their leading axis.

Where JAX hands every collective to XLA, the port's modules read the current
mesh (``use_mesh``) and call the collectives of ``parallel/tp.py`` themselves:
column- and row-parallel products, a vocab-sharded embedding and lm head.
The train step sums gradients and metrics over ``data``.

A mesh needs a process group: ``init_distributed()`` (torchrun's environment,
opt-in by ``MIMIC_TPU_DISTRIBUTED=1``) or the caller's own
``torch.distributed.init_process_group``.  Asking for a mesh without one
raises; nothing falls back to one process silently.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike


class PartitionSpec(tuple):
    """Per-dimension mesh axis of a leaf (``None``: not split), printed as JAX
    prints its ``PartitionSpec``; ``PartitionSpec()`` is replicated."""

    def __new__(cls, *axes: Optional[str]):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec


def make_mesh(n_data: int = -1, n_model: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the process group's world; ``n_data=-1``
    takes every rank ``n_model`` leaves.  ``device_type`` is ``"cuda"`` unless
    the caller asks for ``"cpu"`` (a ``gloo`` group)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call init_distributed() or "
            "torch.distributed.init_process_group first"
        )
    n = dist.get_world_size()
    if n_data == -1:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return init_device_mesh(device_type or "cuda", (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` of ``mesh`` (1 for no mesh or no such axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 for no mesh or no such axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of this rank's line along ``axis``; None where the
    axis has one rank (nothing to communicate)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# the current mesh (JAX: ``with mesh:``)
# ---------------------------------------------------------------------------

_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the current mesh: the decoder, the lm head, the vision
    tower and the train step read it (``current_mesh``)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[DeviceMesh]:
    return _CURRENT[-1] if _CURRENT else None


# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

# (regex on the flattened key path) → spec.  First match wins; default
# replicated.  Layer-stacked leaves have a leading L axis (never sharded).
_PARAM_RULES: Tuple[Tuple[str, PartitionSpec], ...] = (
    # text decoder attention / mlp: shard the head/ffn dim over 'model'
    (r"\['(q|k|v)_proj'\]$", P(None, None, "model")),
    (r"\['o_proj'\]$", P(None, "model", None)),
    (r"\['(gate|up)_proj'\]$", P(None, None, "model")),
    (r"\['down_proj'\]$", P(None, "model", None)),
    (r"\['(q|k|v)_bias'\]$", P(None, "model")),
    # embedding / lm head: shard the vocab dim
    (r"\['embed'\]$", P("model", None)),
    (r"\['lm_head'\]$", P(None, "model")),
    # vision tower dense layers (2D kernels inside the layer stack)
    (r"\['fc1'\]$", P(None, None, "model")),
    (r"\['fc2'\]$", P(None, "model", None)),
    # connector / projector big mats
    (r"\['modality_proj'\]\['(gate|up)'\]$", P(None, "model")),
    (r"\['modality_proj'\]\['down'\]$", P("model", None)),
)

# LoRA / shift params are tiny — replicate them everywhere.


def _spec_for(path_str: str, ndim: int) -> PartitionSpec:
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path_str):
            if len(spec) == ndim:
                return spec
            # rule written for stacked [L, ...] leaves; drop the leading None for
            # unstacked 2D weights
            trimmed = P(*spec[1:]) if len(spec) == ndim + 1 else None
            if trimmed is not None and len(trimmed) == ndim:
                return trimmed
            return P()
    return P()


def _map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(key_path, leaf)`` over a tree of dicts; the key path is spelled as
    ``jax.tree_util.keystr`` spells it (``['lm']['embed']``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    return fn(path, tree)


def _leaf_spec(path: str, leaf: Any, mesh: DeviceMesh) -> PartitionSpec:
    p = _spec_for(path, np.ndim(leaf))
    shape = np.shape(leaf)
    return P(*(
        axis if axis is None or shape[dim] % axis_size(mesh, axis) == 0 else None
        for dim, axis in enumerate(p)
    ))


def param_shardings(params: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """A spec per leaf by key-path rules: the dimension split over ``model``, or
    none.

    Axes whose dimension is not divisible by the mesh axis size fall back to
    replication on that dimension (e.g. a 32003-row vocab under 8-way model
    parallelism stays replicated rather than erroring)."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, leaf, mesh), params)


def replicated(mesh: DeviceMesh) -> PartitionSpec:
    return P()


def batch_shardings(batch: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """Shard every batch leaf over 'data' on its leading axis."""
    return _map_with_path(lambda path, x: P("data"), batch)


def _block(x: Any, dim: int, n: int, r: int) -> Any:
    """Block ``r`` of ``n`` contiguous blocks of ``x`` along ``dim`` (a copy, so
    the full leaf can be freed)."""
    size = x.shape[dim] // n
    part = x[(slice(None),) * dim + (slice(r * size, (r + 1) * size),)]
    return part.clone() if isinstance(x, torch.Tensor) else part.copy()


def shard_params(params: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's tree: each leaf the rules split over ``model`` cut to its
    contiguous block at this rank's ``model`` coordinate, the rest as given."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def cut(path: str, leaf: Any) -> Any:
        spec = _leaf_spec(path, leaf, mesh)
        if n == 1 or "model" not in spec:
            return leaf
        return _block(leaf, spec.index("model"), n, r)

    return _map_with_path(cut, params)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's contiguous block of rows at its ``data`` coordinate, as
    ``NamedSharding(P("data"))`` places them.  Leaves are tensors or numpy
    arrays; a dict, a named tuple or a dataclass of them keeps its type; None
    stays None."""
    if "data" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"shard_batch: the mesh has no 'data' axis ({mesh.mesh_dim_names})")
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def cut(x: Any) -> Any:
        if x is None or n == 1 or np.ndim(x) == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: {x.shape[0]} rows do not split over {n} data ranks")
        return _block(x, 0, n, r)

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    if hasattr(batch, "_fields"):
        return batch._replace(**{k: cut(v) for k, v in batch._asdict().items()})
    if hasattr(batch, "__dataclass_fields__"):
        import dataclasses

        return dataclasses.replace(batch, **{k: cut(getattr(batch, k))
                                             for k in batch.__dataclass_fields__})
    return cut(batch)


def replicate(tree: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """Every rank holds the first rank's values: each tensor leaf is broadcast
    in place from the mesh's first rank.  Returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(path: str, leaf: Any) -> Any:
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(leaf, src)
        return leaf

    _map_with_path(bcast, tree)
    return tree


# ---------------------------------------------------------------------------
# process group from torchrun's environment
# ---------------------------------------------------------------------------


def init_distributed(device: Optional[DeviceLike] = None) -> bool:
    """With ``MIMIC_TPU_DISTRIBUTED=1``: join the process group that torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` describe, over
    ``nccl`` on the cards (each process on ``cuda:LOCAL_RANK``) or ``gloo`` when
    ``device`` is the CPU.  Opt-in, so one process never waits for peers.
    Returns whether a group is up."""
    if os.environ.get("MIMIC_TPU_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return True
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "gloo" if on_cpu else "nccl",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


def is_writer() -> bool:
    """Whether this process writes the run's files (rank 0 of a group, or the
    only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
