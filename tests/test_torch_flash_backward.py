"""mimic_tpu_torch.ops.flash_backward and the differentiable attention against
the JAX package, in fp32 on the CPU.

- ``flash_attention_backward_plain`` (the plain version of the two CUDA
  backward kernels) against the Pallas backward kernels
  (``mimic_tpu.ops.flash_backward.flash_attention_backward``, interpret mode)
  and against ``jax.vjp`` of ``flash_attention_diff`` (its jnp pullback), on
  the same saved forward and the same random cotangents;
- ``flash_attention_diff`` (the port's ``torch.autograd.Function``) against
  ``jax.vjp``;
- the decoder's flash path: its attention outputs carry the Function's
  ``grad_fn``, and the gradients of the shift parameters equal JAX's.

Tolerance: 1e-5 of the largest reference entry of each gradient (fp32, the
sums run in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import decoder as jd
from mimic_tpu.models.config import tiny_text
from mimic_tpu.ops.flash_backward import flash_attention_backward as pallas_backward
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.ops import flash_attention as tfa
from mimic_tpu_torch.ops import flash_backward as tfb
from test_torch_kernels import _t, make_inputs

jfa = importlib.import_module("mimic_tpu.ops.flash_attention")

RTOL = 1e-5

# (causal, need_unmasked, H, Hkv, left_pad, empty_batch_row, with_lse_grads)
CASES = [
    (True, True, 4, 2, 16, False, True),
    (True, False, 4, 2, 16, False, True),
    (False, True, 4, 4, 0, False, True),
    (False, False, 4, 4, 0, False, False),
    (True, True, 4, 1, 0, True, True),
    (True, True, 8, 2, 40, False, False),
]
IDS = ["causal-lseu-gqa-leftpad", "causal-gqa-leftpad", "noncausal-lseu", "noncausal-no-lse-grads",
       "causal-lseu-mqa-empty-row", "causal-lseu-g4-out-grad-only"]


def _case(causal, need_unmasked, H, Hkv, left_pad, empty_row, with_lse_grads, T=128, seed=0):
    q, k, v, km = make_inputs(B=2, T=T, S=T, H=H, Hkv=Hkv, D=128, left_pad=left_pad, seed=seed)
    if empty_row:
        km[1] = 0  # no attendable key anywhere in batch row 1
    out, lse, lse_u = (np.asarray(x) for x in jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km), causal=causal,
        need_unmasked=need_unmasked, block_q=64, block_k=64, interpret=True))
    rng = np.random.default_rng(seed + 1)
    g_out = rng.normal(size=q.shape).astype(np.float32)
    g_lse = rng.normal(size=lse.shape).astype(np.float32) if with_lse_grads else None
    g_lse_u = rng.normal(size=lse.shape).astype(np.float32) if with_lse_grads else None
    return q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("reference", ["pallas", "jnp_vjp"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax(case, reference):
    causal, need_unmasked = case[0], case[1]
    q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u = _case(*case)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    if reference == "pallas":
        want = pallas_backward(j(q), j(k), j(v), j(km), j(out), j(lse), j(lse_u), j(g_out),
                               j(g_lse), j(g_lse_u), causal=causal, block_q=64, block_k=64,
                               need_unmasked=need_unmasked, interpret=True)
    else:
        zeros = np.zeros_like(lse)
        cts = (j(g_out), j(zeros if g_lse is None else g_lse),
               j(zeros if g_lse_u is None else g_lse_u))
        want = jfa._diff_bwd(causal, None, 64, 64, need_unmasked, True,
                             (j(q), j(k), j(v), j(km), j(out), j(lse), j(lse_u)), cts)[:3]
    t = lambda x: None if x is None else _t(x)  # noqa: E731
    got = tfb.flash_attention_backward(t(q), t(k), t(v), t(km), t(out), t(lse), t(lse_u),
                                       t(g_out), t(g_lse), t(g_lse_u), causal=causal,
                                       need_unmasked=need_unmasked)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b, name)


@pytest.mark.parametrize("need_unmasked", [True, False])
def test_autograd_function_matches_jax_vjp(need_unmasked):
    q, k, v, km, _, _, _, g_out, g_lse, g_lse_u = _case(True, need_unmasked, 4, 2, 16, False, True)
    fn = lambda q_, k_, v_: jfa.flash_attention_diff(  # noqa: E731
        q_, k_, v_, jnp.asarray(km), True, None, 64, 64, need_unmasked, True)
    outs_j, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_lse), jnp.asarray(g_lse_u)))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    outs_t = tfa.flash_attention_diff(*leaves, _t(km), True, None, need_unmasked)
    assert type(outs_t[0].grad_fn).__name__ == "FlashAttentionDiffBackward"
    torch.autograd.backward(outs_t, [_t(g_out), _t(g_lse), _t(g_lse_u)])
    for name, a, b in zip(("dq", "dk", "dv"), leaves, want):
        _close(a.grad, b, name)
    valid = np.asarray(outs_j[1]) > -1e29
    _close(outs_t[1][torch.from_numpy(valid)], np.asarray(outs_j[1])[valid], "lse")


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("logz2", ["unmasked", "masked"])
def test_decoder_flash_path_gradients_match_jax(logz2):
    cfg = tiny_text("idefics2", head_dim=128).text
    params = jax.tree.map(np.asarray, jd.init_decoder_params(cfg, jax.random.PRNGKey(0)))
    enc_cfg, _ = get_preset("mimic")
    shift = init_shift_params(enc_cfg, cfg, jax.random.PRNGKey(1))
    shift = jax.tree.map(lambda x: np.asarray(x) * 50.0, shift)
    B, T = 2, 128
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, :20] = 0
    mask[1, 60:62] = 0
    w = rng.normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    pos = np.asarray(jd.positions_from_mask(jnp.asarray(mask)))

    def loss_j(s):
        out = jd.decoder_forward(params, cfg, jnp.asarray(embeds), None, jnp.asarray(pos),
                                 shift=s, key_mask=jnp.asarray(mask), attn_impl="flash",
                                 logz2=logz2)
        return jnp.sum(out.hidden * w)

    jd.ATTN_PATH_LOG.clear()
    want = jax.grad(loss_j)(jax.tree.map(jnp.asarray, shift))
    assert jd.ATTN_PATH_LOG == ["flash"]

    td.ATTN_PATH_LOG.clear()
    shift_t = {k: v.requires_grad_(True) for k, v in to_torch(shift, "cpu").items()}
    out = td.decoder_forward(to_torch(params, "cpu"), cfg, _t(embeds), None, _t(pos),
                             shift=shift_t, key_mask=_t(mask), attn_impl="flash", logz2=logz2)
    assert td.ATTN_PATH_LOG == ["flash"]
    # layers 1.. differentiate through the Function (layer 0's q/k/v need no grad)
    assert "FlashAttentionDiffBackward" in _graph_names(out.hidden)
    (out.hidden * _t(w)).sum().backward()
    for name, leaf in shift_t.items():
        _close(leaf.grad, want[name], name)
