"""mimic_tpu_torch.train.optim against ``mimic_tpu.train.optim`` (optax), step
for step on the same gradient sequences, fp32 on the CPU.

Covered: global-norm clipping (optax scales by max/norm only when
norm >= max), warm-up (the first update uses lr = 0, weight decay included),
the no-decay mask for ``*bias*`` / ``*logz1_b*`` leaves, the ``scale_lr``
group for ``*logz1*`` / ``*scale*`` leaves, and ``MultiSteps``-style
accumulation.  Tolerance on every leaf of the update and the parameters after
each step: rtol 1e-5, atol 1e-7 (an fp32 ulp of the O(1) parameters; the
two sides round the Adam update in different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mimic_tpu.train.optim import build_optimizer as jax_build
from mimic_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.train import optim as to

TREE_SHAPES = {
    "shift": {"attn_v": (3, 2, 8), "attn_logz1_w": (3, 2, 8), "attn_logz1_b": (3, 2),
              "ffn_shift": (3, 16), "ffn_scale": (3,)},
    "extra": {"q_bias": (5,), "weight": (4, 4)},
}


def _tree(rng, scale=1.0):
    return {g: {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in leaves.items()}
            for g, leaves in TREE_SHAPES.items()}


def _close(got, want):
    flat_g, flat_w = to.flatten(got), to.flatten(want)
    assert set(flat_g) == set(flat_w)
    for p, w in flat_w.items():
        np.testing.assert_allclose(flat_g[p].numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=str(p))


def _run(steps, grad_scales, **kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tx_j = jax_build(params, **kw)
    state_j = tx_j.init(params)
    params_j = jax.tree.map(jnp.asarray, params)
    params_t = to_torch(params, "cpu")
    tx_t = to.build_optimizer(params_t, **kw)
    state_t = tx_t.init(params_t)
    for i in range(steps):
        grads = _tree(rng, scale=grad_scales[i % len(grad_scales)])
        upd_j, state_j = tx_j.update(jax.tree.map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, upd_j)
        upd_t, state_t = tx_t.update(to_torch(grads, "cpu"), state_t, params_t)
        params_t = to.apply_updates(params_t, upd_t)
        _close(upd_t, upd_j)
        _close(params_t, params_j)
    return params_t


# (grad_clip, warmup, scale_lr, accumulate); gradient scales alternate below
# and above the clip threshold
OPT_CASES = [
    (1.0, 0, None, 1),
    (1.0, 2, None, 1),
    (None, 2, None, 1),
    (1.0, 2, 1e-2, 1),
    (1.0, 0, 1e-2, 1),
    (1.0, 2, None, 3),
    (None, 0, 1e-2, 2),
    (0.5, 3, 1e-2, 2),
]


@pytest.mark.parametrize("grad_clip,warmup,scale_lr,accumulate", OPT_CASES)
def test_updates_match_optax(grad_clip, warmup, scale_lr, accumulate):
    _run(8, [0.01, 3.0, 0.2], lr=5e-3, weight_decay=1e-2, warmup_steps=warmup, total_steps=12,
         grad_clip=grad_clip, scale_lr=scale_lr, accumulate_steps=accumulate)


def test_warmup_first_update_is_zero_including_weight_decay():
    rng = np.random.default_rng(1)
    params = to_torch(_tree(rng), "cpu")
    tx = to.build_optimizer(params, lr=5e-3, weight_decay=0.5, warmup_steps=4, total_steps=10)
    upd, state = tx.update(to_torch(_tree(rng), "cpu"), tx.init(params), params)
    assert all(torch.count_nonzero(u) == 0 for u in to.flatten(upd).values())
    upd, _ = tx.update(to_torch(_tree(rng), "cpu"), state, params)
    assert all(torch.count_nonzero(u) > 0 for u in to.flatten(upd).values())


def test_clip_scales_only_at_or_above_the_threshold():
    params = {"w": torch.zeros(4)}
    tx = to.build_optimizer(params, lr=1.0, weight_decay=0.0, warmup_steps=0, total_steps=10,
                            grad_clip=1.0, b1=0.0, b2=0.0, eps=0.0)
    # with b1 = b2 = 0 Adam returns g / |g| elementwise, so probe the clip via
    # the first moment kept in the state
    below = {"w": torch.tensor([0.3, 0.4, 0.0, 0.0])}   # norm 0.5: unchanged
    at = {"w": torch.tensor([0.6, 0.8, 0.0, 0.0])}      # norm 1.0: scaled by 1/1
    above = {"w": torch.tensor([3.0, 4.0, 0.0, 0.0])}   # norm 5.0: scaled to norm 1
    for g, want in ((below, below["w"]), (at, at["w"]), (above, above["w"] / 5.0)):
        _, state = tx.update(g, tx.init(params), params)
        torch.testing.assert_close(state["mu"][("w",)], want)


def test_decay_mask_and_scale_group_labels():
    assert not to._is_decayed(("shift", "attn_logz1_b"))
    assert not to._is_decayed(("extra", "q_bias"))
    assert to._is_decayed(("shift", "attn_logz1_w")) and to._is_decayed(("shift", "attn_v"))
    assert to._is_scale_group(("shift", "attn_logz1_w"))
    assert to._is_scale_group(("shift", "ffn_scale"))
    assert not to._is_scale_group(("shift", "attn_v"))


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (10, 10)])
def test_schedule_matches_jax(warmup, total):
    mine, ref = to.cosine_warmup_schedule(5e-3, warmup, total), jax_schedule(5e-3, warmup, total)
    for step in range(total + 3):
        assert abs(mine(step) - float(ref(jnp.asarray(step, jnp.int32)))) <= 1e-9
