"""mimic_tpu_torch.utils.tracing against the JAX package's, fp32, on the CPU.

A tiny idefics2 (and its text-tower variants) carried across by
``bridge.to_torch``: ``capture_forward``'s logits and captures within 1e-5 of
JAX's; ``capture_grads`` within 1e-4 relative of JAX's ``jax.grad`` and of a
finite difference, on the plain path and on the attention kernels' path
(their plain versions here, head dim 128 on a 128-token batch);
``attention_probs`` within 1e-5 (biases, qk-norms, a sliding window narrower
than T).  The decoder options behind them (``capture_layer_inputs``,
``perturb_attn`` / ``perturb_ffn``) are held to the JAX decoder with and
without ``remat``, gradients included.  ``profile`` writes a Chrome trace.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import decoder as jd
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.utils import tracing as jtr
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.utils import tracing as ttr

TOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(cfg, B, T, seed=0, pad=0):
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(seed)))
    layers = params["lm"]["decoder"]["layers"]
    rng = np.random.default_rng(seed)
    for name in ("q_bias", "k_bias", "v_bias"):
        if name in layers:  # non-zero biases, so that they count
            layers[name] = rng.normal(scale=0.1, size=layers[name].shape).astype(np.float32)
    ids = rng.integers(3, 250, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, :pad] = 0  # left padding in row 0
    jb = jlvlm.LVLMBatch(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tb = tlvlm.LVLMBatch(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask))
    return params, to_torch(params, "cpu"), jb, tb


@pytest.fixture(scope="module")
def idefics2():
    cfg = get_model_config("tiny-idefics2")
    return (cfg, *_setup(cfg, 2, 12))


@pytest.fixture(scope="module")
def flash():
    """Head dim 128 on a 128-token batch: both sides take the "flash" path."""
    cfg = tiny_text("idefics2", head_dim=128)
    return (cfg, *_setup(cfg, 2, 128, pad=20))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_capture_forward_matches_jax(idefics2):
    cfg, jp, tp, jb, tb = idefics2
    jlogits, jcaps = jtr.capture_forward(jp, cfg, jb)
    logits, caps = ttr.capture_forward(tp, cfg, tb)
    L, D = cfg.text.num_layers, cfg.text.hidden_size
    assert caps["attn"].shape == caps["ffn"].shape == (L, 2, 12, D)
    _close(logits, jlogits)
    for name in ("attn", "ffn"):
        _close(caps[name], jcaps[name])


def _rel_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= GRAD_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("path", ["xla", "flash"])
def test_capture_grads_match_jax(idefics2, flash, path):
    cfg, jp, tp, jb, tb = idefics2 if path == "xla" else flash
    kw = {"attn_impl": path}
    want = jtr.capture_grads(jp, cfg, jb, lambda lg: jnp.sum(lg.astype(jnp.float32) ** 2), **kw)
    td.ATTN_PATH_LOG.clear()
    got = ttr.capture_grads(tp, cfg, tb, lambda lg: (lg.float() ** 2).sum(), **kw)
    assert td.ATTN_PATH_LOG == [path]
    for name in ("attn", "ffn"):
        assert float(got[name].abs().max()) > 0
        _rel_close(got[name], want[name])


def test_capture_grads_match_finite_difference(idefics2):
    cfg, _, tp, _, tb = idefics2
    loss_fn = lambda lg: lg.float().mean()
    grads = ttr.capture_grads(tp, cfg, tb, loss_fn)
    eps = 1e-3
    pa = torch.zeros(cfg.text.num_layers, 2, 12, cfg.text.hidden_size)
    pa_plus = pa.clone()
    pa_plus[1, 0, 3, 5] += eps
    with torch.no_grad():
        base = float(loss_fn(tlvlm.lvlm_forward(tp, cfg, tb, perturb_attn=pa).logits))
        plus = float(loss_fn(tlvlm.lvlm_forward(tp, cfg, tb, perturb_attn=pa_plus).logits))
    assert float(grads["attn"][1, 0, 3, 5]) == pytest.approx((plus - base) / eps,
                                                             rel=1e-2, abs=1e-5)


@pytest.mark.parametrize("case", ["idefics2", "llava-biases", "text-window-qk-norms"])
def test_attention_probs_match_jax(case):
    if case == "idefics2":
        cfg = get_model_config("tiny-idefics2")
    elif case == "llava-biases":
        cfg = get_model_config("tiny-llava-interleave")
    else:
        cfg = tiny_text("text", sliding_window=5, qk_layernorm=True)
    jp, tp, jb, tb = _setup(cfg, 2, 12, pad=3)
    want = jtr.attention_probs(jp, cfg, jb, layer=1)
    probs = ttr.attention_probs(tp, cfg, tb, layer=1)
    assert probs.shape == (2, cfg.text.num_heads, 12, 12) and probs.dtype == torch.float32
    _close(probs, want)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    # rows with an attendable key put nothing above the diagonal, on padding or
    # outside the window (a padded query row attends none and is uniform, as in JAX)
    allowed = td.make_causal_mask(tb.attention_mask, cfg.text.sliding_window).numpy()
    upper = ~np.tril(np.ones((12, 12), bool))
    assert (upper & allowed).sum() == 0
    live = allowed.any(-1, keepdims=True)
    assert np.abs(np.where(live & ~allowed, probs.numpy(), 0.0)).max() < 1e-6
    if cfg.text.sliding_window:
        assert (~allowed[1, 0] & ~upper).any()  # the window cuts keys below the diagonal


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_layer_inputs_and_perturbations_match_jax(remat):
    """decoder_forward with the layer-input captures and both perturbations:
    hidden states, captures and the gradients of a weighted sum of the hidden
    states with respect to the perturbations, against JAX (1e-5)."""
    cfg = tiny_text("idefics2").text
    params = jax.tree.map(np.asarray, jd.init_decoder_params(cfg, jax.random.PRNGKey(0)))
    B, T, L, D = 2, 10, cfg.num_layers, cfg.hidden_size
    rng = np.random.default_rng(1)
    embeds, w = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
    pa, pf = (rng.normal(scale=0.1, size=(L, B, T, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, T), np.int32)
    mask[1, :2] = 0
    j = jnp.asarray

    def jax_fwd(pa_, pf_):
        out = jd.decoder_forward(
            params, cfg, j(embeds), jd.make_causal_mask(j(mask)), jd.positions_from_mask(j(mask)),
            key_mask=j(mask), capture_attn=True, capture_ffn=True, capture_layer_inputs=True,
            perturb_attn=pa_, perturb_ffn=pf_, remat=remat,
        )
        return jnp.sum(out.hidden * j(w)), out

    (_, ref), (ga, gf) = jax.value_and_grad(jax_fwd, argnums=(0, 1), has_aux=True)(j(pa), j(pf))
    tpa, tpf = (torch.from_numpy(x).requires_grad_() for x in (pa, pf))
    tmask = torch.from_numpy(mask)
    out = td.decoder_forward(
        to_torch(params, "cpu"), cfg, torch.from_numpy(embeds), td.make_causal_mask(tmask),
        td.positions_from_mask(tmask), key_mask=tmask, capture_attn=True, capture_ffn=True,
        capture_layer_inputs=True, perturb_attn=tpa, perturb_ffn=tpf, remat=remat,
    )
    assert out.layer_inputs.shape == (L, B, T, D)
    _close(out.layer_inputs[0], embeds)
    for name in ("hidden", "attn_capture", "ffn_capture", "layer_inputs"):
        _close(getattr(out, name), getattr(ref, name))
    (out.hidden * torch.from_numpy(w)).sum().backward()
    _close(tpa.grad, ga)
    _close(tpf.grad, gf)


def test_profile_writes_a_chrome_trace(tmp_path):
    with ttr.profile(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
