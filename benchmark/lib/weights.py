"""Random weights made on the device from the run's seed.

The tree has the layout the port's ``build_model(..., params=...)`` takes
(stacked ``[L, ...]`` leaves, weights stored ``[in, out]``) and the plain
reference reads: both sides are handed the same tensors' values.  Each leaf
is one ``torch.randn`` call from one ``torch.Generator`` on the device, in
the served dtype, so a cell's ~17 GB take a few dozen large calls.

Dense weights, embeddings, latents and biases are N(0, 1)·0.02; norm weights
are 1 + N(0, 1)·0.02, so that neither a skipped bias nor a skipped norm weight
goes unseen by the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import registry

STD = 0.02


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The widths and depths the configuration's tree is built from, by its
    family (``reference/<family>.py::sizes``)."""
    return registry.reference(cfg["family"]).sizes(cfg)


def specs(cfg: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in the order they are drawn; init
    is "dense", "norm" or "bias" (``reference/<family>.py::specs``)."""
    fam = registry.reference(cfg["family"])
    return fam.specs(cfg, fam.sizes(cfg))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2**63)


def make_weights(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cell's weights from ``seed``: the same seed gives the same tensors."""
    gen = generator(seed, 1, device)
    tree: Dict[str, Any] = {}
    for path, shape, init in specs(cfg):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(STD)
        if init == "norm":
            x.add_(1.0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def make_shift(cfg: Dict[str, Any], init: Dict[str, float], seed: int, device) -> Dict[str, torch.Tensor]:
    """The MimIC multi-head shift, fp32, in the family's shapes
    (``reference/<family>.py::shift_shapes``): v ~ N(0,1)·``attn_v_std``,
    the log Z1 weight ~ N(0,1)·``logz1_w_std``, its bias ``logz1_b``."""
    fam = registry.reference(cfg["family"])
    shapes = fam.shift_shapes(fam.sizes(cfg))
    gen = generator(seed, 2, device)
    v = torch.randn(shapes["attn_v"], generator=gen, device=device) * init["attn_v_std"]
    w = torch.randn(shapes["attn_logz1_w"], generator=gen, device=device) * init["logz1_w_std"]
    b = torch.full(shapes["attn_logz1_b"], float(init["logz1_b"]), device=device)
    return {"attn_v": v, "attn_logz1_w": w, "attn_logz1_b": b}
