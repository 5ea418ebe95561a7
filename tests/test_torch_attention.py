"""mimic_tpu_torch.ops.flash_attention: the plain version against the JAX Pallas
kernels (interpret mode, as tests/test_flash_attention.py runs them).  The
dispatch rule, the launch counters and the CUDA kernels themselves are tested
in test_torch_kernels.py, which imports no JAX so that it runs on the card.

Tolerances (fp32): out atol 2e-5, lse / lse_u atol 1e-5 on rows with at least
one attendable key; rows with none are checked to be finite.  The JAX kernels
run their softmax in the log2 domain; the plain version in ln — the difference
is fp32 rounding.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu_torch.ops import flash_attention as tfa
from test_torch_kernels import _t, _valid_rows, make_inputs

# mimic_tpu.ops re-exports the function under the module's name
jfa = importlib.import_module("mimic_tpu.ops.flash_attention")

OUT_ATOL = 2e-5
LSE_ATOL = 1e-5


def _compare(port, ref, km, causal, need_unmasked, all_rows_out=False):
    out_t, lse_t, lse_u_t = (x.numpy() for x in port)
    out_j, lse_j, lse_u_j = (np.asarray(x) for x in ref)
    T = out_t.shape[1]
    valid = _valid_rows(km, T, causal)
    assert np.isfinite(out_t).all() and np.isfinite(lse_t).all() and np.isfinite(lse_u_t).all()
    if all_rows_out:
        np.testing.assert_allclose(out_t, out_j, atol=OUT_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(out_t[valid], out_j[valid], atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse_t[valid], lse_j[valid], atol=LSE_ATOL, rtol=0)
    if need_unmasked:
        np.testing.assert_allclose(lse_u_t, lse_u_j, atol=LSE_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(lse_u_t, lse_t)


CASES = [
    # (causal, need_unmasked, H, Hkv, D, left_pad)
    (True, True, 4, 2, 128, 16),
    (True, False, 4, 2, 128, 16),
    (False, True, 4, 4, 72, 0),
    (False, False, 4, 4, 72, 0),
    (True, True, 4, 1, 72, 0),
    (False, True, 4, 2, 128, 0),
]


@pytest.mark.parametrize("causal,need_unmasked,H,Hkv,D,left_pad", CASES)
def test_plain_matches_jax_flash_kernel(causal, need_unmasked, H, Hkv, D, left_pad):
    q, k, v, km = make_inputs(H=H, Hkv=Hkv, D=D, left_pad=left_pad, seed=D + H)
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
        causal=causal, need_unmasked=need_unmasked, block_q=64, block_k=64, interpret=True,
    )
    port = tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                               need_unmasked=need_unmasked)
    # the online kernel's rows with no attendable key average only the blocks it
    # visited; the plain version (and onepass) average all S keys
    _compare(port, ref, km, causal, need_unmasked)


@pytest.mark.parametrize("causal,need_unmasked,H,Hkv,D,left_pad", CASES)
def test_onepass_matches_jax_onepass_kernel(causal, need_unmasked, H, Hkv, D, left_pad):
    q, k, v, km = make_inputs(H=H, Hkv=Hkv, D=D, left_pad=left_pad, seed=D + H + 1)
    ref = jfa.onepass_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
        causal=causal, need_unmasked=need_unmasked, interpret=True,
    )
    port = tfa.onepass_attention(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                 need_unmasked=need_unmasked)
    # full-row contract: rows with no attendable key agree too (mean of v over S)
    _compare(port, ref, km, causal, need_unmasked, all_rows_out=True)


@pytest.mark.parametrize("S", [1000, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_key_axis_matches_jax_plain_path(S, causal):
    # S not 128-aligned routes to flash_fwd's contract; JAX's plain-XLA path
    # (_sdpa_fallback) takes any S
    q, k, v, km = make_inputs(B=2, T=S, S=S, H=4, Hkv=2, D=72, seed=S, left_pad=5)
    ref = jfa._sdpa_fallback(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(km), causal, None, True)
    port = tfa.flash_attention(_t(q), _t(k), _t(v), _t(km), causal=causal)
    _compare(port, ref, km, causal, True, all_rows_out=True)


def test_rows_without_keys_are_finite_uniform_means():
    q, k, v, km = make_inputs(B=1, T=128, S=128, H=2, Hkv=2, D=64)
    km[0] = 0
    out, lse, lse_u = tfa.flash_attention(_t(q), _t(k), _t(v), _t(km), causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out[0, 5].numpy(), v[0].mean(0), atol=1e-5)
