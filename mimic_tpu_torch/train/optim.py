"""Optimizer: AdamW + cosine-with-warmup with the reference's param groups.

Counterpart of ``mimic_tpu/train/optim.py``, written as plain functions on
tensors and held to its optax chain step for step:

    MultiSteps(k)( clip_by_global_norm(c) → multi_transform({
        group: scale_by_adam → add_decayed_weights(wd, mask) →
               scale_by_learning_rate(cosine_warmup(peak)) }) )

What that chain does, and this module with it:

- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead);
- the schedule is read at the inner count *before* it increments, so with
  warm-up the first update uses lr = 0, and weight decay (added before the
  lr scale) is scaled by that lr too;
- leaves named ``*bias*`` / ``*logz1_b*`` get no weight decay;
- with ``scale_lr``, leaves named ``*logz1*`` / ``*scale*`` train at that
  peak lr instead of ``lr``;
- accumulation over k calls averages the micro-gradients (running mean) and
  applies the inner update on every k-th call; in between the updates are
  zero and the inner state does not move.

An ``Optimizer`` has optax's shape: ``init(params) → state`` and
``update(grads, state, params) → (updates, state)``; ``apply_updates`` adds
them.  Trees are nested dicts of tensors; states hold plain dicts and ints.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Dict[str, Any]]
    update: Callable[[Tree, Dict[str, Any], Tree], Tuple[Tree, Dict[str, Any]]]


def cosine_warmup_schedule(peak_lr: float, warmup_steps: int, total_steps: int):
    """0→peak linear over warmup, then cosine peak→0 at total_steps (HF formula)."""
    warmup_steps = max(int(warmup_steps), 0)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Nested dict → {key path: leaf}, keys sorted at every level (as JAX does)."""
    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def unflatten(flat: Dict[Tuple[str, ...], Any]) -> Tree:
    tree: Tree = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _keystr(path: Tuple[str, ...]) -> str:
    """The path as ``jax.tree_util.keystr`` writes it: ``['shift']['attn_v']``."""
    return "".join(f"['{k}']" for k in path).lower()


def _is_decayed(path: Tuple[str, ...]) -> bool:
    # reference non_decay_names = ["bias"]; the bias-analog leaves end in "_b"
    s = _keystr(path)
    return not ("bias" in s or "logz1_b" in s)


def _is_scale_group(path: Tuple[str, ...]) -> bool:
    s = _keystr(path)
    return "logz1" in s or "scale" in s


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    leaves = list(flatten(tree).values())
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    fu = flatten(updates)
    return unflatten({p: (x + fu[p]).to(x.dtype) for p, x in flatten(params).items()})


def build_optimizer(
    trainable_template: Tree,
    *,
    lr: float,
    weight_decay: float,
    warmup_steps: int,
    total_steps: int,
    grad_clip: Optional[float] = 1.0,
    scale_lr: Optional[float] = None,
    accumulate_steps: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    paths = list(flatten(trainable_template))
    schedules = {
        p: cosine_warmup_schedule(
            scale_lr if scale_lr is not None and _is_scale_group(p) else lr,
            warmup_steps, total_steps,
        )
        for p in paths
    }
    k_steps = max(int(accumulate_steps), 1)

    def init(params: Tree) -> Dict[str, Any]:
        flat = flatten(params)
        zeros = lambda: {p: torch.zeros_like(x, dtype=torch.float32) for p, x in flat.items()}
        state: Dict[str, Any] = {"count": 0, "mu": zeros(), "nu": zeros()}
        if k_steps > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def inner_update(grads, state, params):
        g = {p: x.float() for p, x in grads.items()}
        if grad_clip:
            norm = torch.sqrt(sum(torch.sum(x**2) for x in g.values()))
            if not bool(norm < grad_clip):
                g = {p: (x / norm) * grad_clip for p, x in g.items()}
        count = state["count"]
        count_inc = count + 1
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count_inc
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count_inc
        mu, nu, updates = {}, {}, {}
        for p, x in g.items():
            mu[p] = (1 - b1) * x + b1 * state["mu"][p]
            nu[p] = (1 - b2) * x**2 + b2 * state["nu"][p]
            u = (mu[p] / bc1.to(x.device)) / (torch.sqrt(nu[p] / bc2.to(x.device)) + eps)
            if _is_decayed(p):
                u = u + weight_decay * params[p].float()
            updates[p] = -schedules[p](count) * u
        return updates, {"count": count_inc, "mu": mu, "nu": nu}

    @torch.no_grad()
    def update(grads: Tree, state: Dict[str, Any], params: Tree):
        g, pr = flatten(grads), flatten(params)
        if k_steps == 1:
            updates, state = inner_update(g, state, pr)
            return unflatten(updates), state
        n = state["mini_step"]
        acc = {p: state["acc"][p] + (x.float() - state["acc"][p]) / (n + 1) for p, x in g.items()}
        inner = {key: state[key] for key in ("count", "mu", "nu")}
        if n == k_steps - 1:
            updates, inner = inner_update(acc, inner, pr)
            acc = {p: torch.zeros_like(x) for p, x in acc.items()}
            new = dict(inner, mini_step=0, gradient_step=state["gradient_step"] + 1, acc=acc)
        else:
            updates = {p: torch.zeros_like(x) for p, x in acc.items()}
            new = dict(inner, mini_step=n + 1, gradient_step=state["gradient_step"], acc=acc)
        return unflatten(updates), new

    return Optimizer(init=init, update=update)
