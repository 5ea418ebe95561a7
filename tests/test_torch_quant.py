"""mimic_tpu_torch.ops.quant and the int8 serving modes against the JAX package.

Same numpy inputs on both sides; each test states its tolerance.

- The transform (``quantize_weight``, ``quantize_lm_params``,
  ``concat_quantized``, ``mark_act_quant``): the same ``q8`` bytes and the
  same fp32 ``scale`` bits as ``mimic_tpu.ops.quant``, in fp32 and bf16.
- The kernels' plain versions (what a CPU tensor runs) against the JAX Pallas
  kernels in interpret mode: fp32 within 1e-5 of max |reference| (summation
  order), bf16 within 1e-2 (one rounding of the bf16 output, 2^-8).
- ``qdot`` against JAX ``qdot`` on the CPU (the dequantized fp32 product),
  its gradient, and the ``Int8MatmulDiff`` Function's gradient, 1e-5.
- ``lm_forward`` / ``lvlm_forward`` on a quantized tree: fp32 logits 2e-5.
- Greedy and beam-3 generation in the ``"int8"`` and ``"int8-memory"`` modes,
  with and without a MimIC shift: tokens identical in fp32.
- ``LVLMRunner.set_quant`` modes, the bridge round trip of quantized trees,
  and the int8 modes with JAX unavailable.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lm as jlm
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.decoder import make_causal_mask as j_causal_mask
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops import quant as jq
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_numpy, to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lm as tlm
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.factory import build_model
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops import quant as tq

TOL_FP32 = 1e-5       # kernels' plain versions vs Pallas interpret, relative to max |ref|
TOL_BF16 = 1e-2       # one bf16 rounding of the output (2^-8 = 3.9e-3 of the value)
TOL_LOGITS = 2e-5     # fp32 logits of a quantized tree
NEW_TOKENS = 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def assert_same_bytes(jax_tree, torch_tree):
    """Same keys, dtypes, shapes and bytes (bf16 compared as bit patterns)."""
    want = _flat(np_tree(jax_tree))
    got = _flat(to_numpy(torch_tree, bfloat16=jnp.bfloat16))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g.view(np.uint8), np.ascontiguousarray(w).view(np.uint8)), path


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ---------------------------------------------------------------------------
# the transform, bit-exact
# ---------------------------------------------------------------------------


def _weight(shape, seed, zero_column=False):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_column:
        w[..., 3] = 0.0
    return w


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,kw,zero_col", [
    ((64, 200), {}, False),                       # 2-D, N padded to 256
    ((200, 128), {"pad_k": True}, False),         # ragged K padded to 256
    ((3, 64, 200), {}, False),                    # stacked, padded N
    ((2, 128, 256), {"act_quant": True}, False),  # stacked with the a8 marker
    ((3, 64, 128), {}, True),                     # an all-zero column: scale 1
    ((64, 128), {}, True),
], ids=["2d-pad-n", "pad-k", "stacked", "act-quant", "stacked-zero-col", "2d-zero-col"])
def test_quantize_weight_bytes_match_jax(shape, kw, zero_col, dtype):
    jdt, tdt = DTYPES[dtype]
    w = jnp.asarray(_weight(shape, sum(shape), zero_col)).astype(jdt)
    want = jq.quantize_weight(w, **kw)
    got = tq.quantize_weight(to_torch(np.asarray(w), "cpu"), **kw)
    assert_same_bytes(want, got)
    if zero_col:
        assert (got["scale"][..., 3] == 1.0).all()


def _tiny_lvlm(dtype=jnp.float32):
    tk = SimpleTokenizer(padding_side="left")
    cfg = get_model_config("tiny-idefics2")
    cfg = cfg.replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
        text=cfg.text.__class__(**{**cfg.text.__dict__, "vocab_size": tk.vocab_size}),
    )
    params = jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    return cfg, np_tree(params), tk


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", [{}, {"fuse": False}, {"act_quant": True}],
                         ids=["fused", "unfused", "act-quant"])
def test_quantize_lm_params_bytes_match_jax(kw, dtype):
    _, params, _ = _tiny_lvlm(DTYPES[dtype][0])
    want = jq.quantize_lm_params(params, **kw)
    params_t = to_torch(params, "cpu")
    got = tq.quantize_lm_params(params_t, **kw)
    assert_same_bytes(want, got)
    # shared, not copied: the vision tower and the norms are the input's tensors
    assert got["vision"] is params_t["vision"]
    assert got["lm"]["decoder"]["layers"]["input_ln"] is params_t["lm"]["decoder"]["layers"]["input_ln"]
    # the input tree is not mutated
    assert "q_proj" in params_t["lm"]["decoder"]["layers"]
    assert not tq.is_quantized(params_t["lm"]["lm_head"])


def test_concat_quantized_and_mark_act_quant_match_jax():
    parts = [_weight((2, 64, 128), 1), _weight((2, 64, 256), 2)]
    jparts = [jq.quantize_weight(jnp.asarray(p), act_quant=True) for p in parts]
    tparts = [tq.quantize_weight(_t(p), act_quant=True) for p in parts]
    assert_same_bytes(jq.concat_quantized(jparts), tq.concat_quantized(tparts))
    # the fused bytes equal quantizing the concatenation (per-column scales)
    assert_same_bytes(jq.quantize_weight(jnp.concatenate([jnp.asarray(p) for p in parts], -1)),
                      tq.concat_quantized([tq.quantize_weight(_t(p)) for p in parts]))
    padded = tq.quantize_weight(_t(_weight((64, 200), 3)))
    with pytest.raises(ValueError):
        tq.concat_quantized([padded, tparts[0]])
    with pytest.raises(ValueError):
        jq.concat_quantized([jq.quantize_weight(jnp.asarray(_weight((64, 200), 3))), jparts[0]])

    _, params, _ = _tiny_lvlm()
    jmem = jq.quantize_lm_params(params)
    tmem = tq.quantize_lm_params(to_torch(params, "cpu"))
    marked = tq.mark_act_quant(tmem)
    assert_same_bytes(jq.mark_act_quant(jmem), marked)
    layers, orig = marked["lm"]["decoder"]["layers"], tmem["lm"]["decoder"]["layers"]
    assert "a8" in layers["qkv_proj"] and "a8" not in orig["qkv_proj"]
    assert layers["qkv_proj"]["q8"] is orig["qkv_proj"]["q8"]  # re-tagged, not copied


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _check(got, want, dtype):
    tol = TOL_FP32 if dtype == "float32" else TOL_BF16
    err = _rel_err(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N", [(16, 256, 384), (32, 512, 128)])
def test_int8_matmul_plain_matches_pallas(M, K, N, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    want = jq.int8_matmul(jnp.asarray(x).astype(jdt), q["q8"], q["scale"], block_m=16,
                          block_n=128, block_k=128, interpret=True)
    qt = to_torch(np_tree(q), "cpu")
    tq.reset_launch_counts()
    got = tq.int8_matmul(_t(x, tdt), qt["q8"], qt["scale"])
    assert got.dtype == tdt and tq.LAUNCHES["int8_matmul"] == 0
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_matmul_stacked_plain_matches_pallas_at_each_layer(dtype):
    jdt, tdt = DTYPES[dtype]
    L, M, K, N = 3, 16, 256, 256
    rng = np.random.default_rng(9)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = jq.quantize_weight(jnp.asarray(rng.normal(size=(L, K, N)).astype(np.float32)))
    qt = to_torch(np_tree(q), "cpu")
    for layer in range(L):
        want = jq.int8_matmul_stacked(jnp.asarray(x).astype(jdt), q["q8"], q["scale"],
                                      jnp.int32(layer), block_m=16, block_n=128, block_k=128,
                                      interpret=True)
        got = tq.int8_matmul_stacked(_t(x, tdt), qt["q8"], qt["scale"], layer)
        _check(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_mlp_plain_matches_pallas_at_each_layer(dtype):
    jdt, tdt = DTYPES[dtype]
    L, M, D, F = 2, 16, 128, 512
    rng = np.random.default_rng(20)
    x = rng.normal(size=(M, D)).astype(np.float32)
    qgu = jq.quantize_weight(jnp.asarray(rng.normal(size=(L, D, 2 * F)).astype(np.float32)))
    qd = jq.quantize_weight(jnp.asarray(rng.normal(size=(L, F, D)).astype(np.float32) / np.sqrt(F)))
    gu, dn = to_torch(np_tree(qgu), "cpu"), to_torch(np_tree(qd), "cpu")
    for layer in range(L):
        want = jq.fused_mlp_stacked(jnp.asarray(x).astype(jdt), qgu["q8"], qgu["scale"], qd["q8"],
                                    qd["scale"], jnp.int32(layer), block_f=256, interpret=True)
        got = tq.fused_mlp_stacked(_t(x, tdt), gu["q8"], gu["scale"], dn["q8"], dn["scale"], layer)
        assert got.dtype == tdt
        _check(got, want, dtype)


def test_fused_mlp_declines_like_jax_on_the_cpu():
    gu = tq.quantize_weight(torch.ones(2, 64, 512))
    down = tq.quantize_weight(torch.ones(2, 256, 64))
    x = torch.ones(4, 64)
    jgu = jq.quantize_weight(jnp.ones((2, 64, 512)))
    jdown = jq.quantize_weight(jnp.ones((2, 256, 64)))
    assert tq.fused_mlp(x, gu, down) is None and jq.fused_mlp(jnp.ones((4, 64)), jgu, jdown) is None
    # stacked handles: the CPU declines, as JAX off the TPU does
    assert tq.fused_mlp(x, dict(gu, layer=0), dict(down, layer=0)) is None
    assert jq.fused_mlp(jnp.ones((4, 64)), dict(jgu, layer=jnp.int32(0)),
                        dict(jdown, layer=jnp.int32(0))) is None


# ---------------------------------------------------------------------------
# qdot
# ---------------------------------------------------------------------------

QDOT_CASES = {
    "plain": dict(x=(2, 3, 64), w=(64, 96)),
    "quantized-pad-n": dict(x=(2, 7, 64), w=(64, 200), quant={}),
    "stacked-handle": dict(x=(2, 5, 64), w=(4, 64, 128), quant={}, layer=2),
    "pad-k": dict(x=(4, 200), w=(200, 128), quant={"pad_k": True}),
    "a8-prefill-m": dict(x=(300, 64), w=(64, 200), quant={"act_quant": True}),
    "preferred-fp32": dict(x=(4, 64), w=(64, 128), quant={}, x_dtype="bfloat16",
                           preferred=True),
}


def _qdot_inputs(case):
    c = QDOT_CASES[case]
    rng = np.random.default_rng(len(case))
    jdt, tdt = DTYPES[c.get("x_dtype", "float32")]
    x = jnp.asarray(rng.normal(size=c["x"]).astype(np.float32)).astype(jdt)
    w = jnp.asarray(rng.normal(size=c["w"]).astype(np.float32))
    if "quant" in c:
        w = jq.quantize_weight(w, **c["quant"])
        if "layer" in c:
            w = dict(w, layer=jnp.int32(c["layer"]))
    wt = to_torch(np_tree(w), "cpu")
    if isinstance(wt, dict) and "layer" in wt:
        wt["layer"] = int(wt["layer"])
    pref = (jnp.float32, torch.float32) if c.get("preferred") else (None, None)
    return x, w, to_torch(np.asarray(x), "cpu"), wt, pref


@pytest.mark.parametrize("case", list(QDOT_CASES))
def test_qdot_matches_jax_on_the_cpu(case):
    x, w, xt, wt, (jpref, tpref) = _qdot_inputs(case)
    want = jq.qdot(x, w, preferred_element_type=jpref)
    tq.reset_launch_counts()
    got = tq.qdot(xt, wt, preferred_element_type=tpref)
    assert tq.LAUNCHES == {"int8_matmul": 0, "fused_mlp_int8": 0, "w8a8_matmul": 0}
    assert got.shape == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("case", ["quantized-pad-n", "stacked-handle"])
def test_qdot_gradient_matches_jax_grad(case):
    x, w, xt, wt, _ = _qdot_inputs(case)
    n = (wt["scale"].shape[-1],)
    g = np.random.default_rng(40).normal(size=x.shape[:-1] + n).astype(np.float32)
    want = jax.grad(lambda x_: jnp.sum(jq.qdot(x_, w) * g))(x)

    # qdot on the CPU: autograd through the dequantized product
    xg = xt.clone().requires_grad_(True)
    (tq.qdot(xg, wt) * _t(g)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(want), rtol=TOL_FP32, atol=TOL_FP32)

    # the autograd Function the card path takes (here its forward is the plain
    # version); its backward is JAX's _input_vjp pullback dY @ deq(W)^T
    xm = xt.reshape(-1, xt.shape[-1])
    xm = torch.nn.functional.pad(xm, (0, wt["q8"].shape[-2] - xm.shape[-1])).requires_grad_(True)
    scale = torch.nn.functional.pad(wt["scale"], (0, wt["q8"].shape[-1] - n[0]))
    out = tq.int8_matmul_diff(xm, wt["q8"], scale, wt.get("layer"))
    assert type(out.grad_fn).__name__ == "Int8MatmulDiffBackward"
    (out[:, : n[0]] * _t(g).reshape(-1, n[0])).sum().backward()
    np.testing.assert_allclose(xm.grad.numpy().reshape(x.shape), np.asarray(want),
                               rtol=TOL_FP32, atol=TOL_FP32)


# ---------------------------------------------------------------------------
# quantized trees through the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_lm_forward_on_a_quantized_tree_matches_jax(fuse):
    cfg = get_model_config("tiny-idefics2").text
    params = np_tree(jlm.init_lm_params(cfg, jax.random.PRNGKey(0)))
    qp = np_tree(jq.quantize_lm_params(params, fuse=fuse))
    ids = np.random.default_rng(3).integers(0, 250, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    want = jlm.lm_forward(qp, cfg, jnp.asarray(ids), attn_mask=j_causal_mask(jnp.asarray(mask)))
    qt = tq.quantize_lm_params(to_torch(params, "cpu"), fuse=fuse)
    got = tlm.lm_forward(qt, cfg, _t(ids).long(), attn_mask=td.make_causal_mask(_t(mask)))
    assert got.logits.dtype == torch.float32
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


TEXTS = [
    "Image:<image> Question: what is shown? Answer:",
    "Image:<image> Question: a much longer question about the picture here? Answer:",
]


def _images(n=2):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(n)]


@pytest.fixture(scope="module")
def gen_setup():
    cfg, params, tk = _tiny_lvlm()
    enc_cfg, _ = get_preset("mimic")
    shift = init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(1))
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    enc = LVLMProcessor(cfg, tk)(_images(), TEXTS)
    jb = jlvlm.LVLMBatch(
        input_ids=jnp.asarray(enc["input_ids"]), attention_mask=jnp.asarray(enc["attention_mask"]),
        pixel_values=jnp.asarray(enc["pixel_values"]), pixel_mask=jnp.asarray(enc["pixel_mask"]),
        patch_mask=jnp.asarray(enc["patch_mask"]),
    )
    tb = tlvlm.LVLMBatch(
        input_ids=_t(enc["input_ids"]).long(), attention_mask=_t(enc["attention_mask"]),
        pixel_values=_t(enc["pixel_values"]), patch_mask=_t(enc["patch_mask"]),
    )
    params_t = to_torch(params, "cpu")
    return dict(cfg=cfg, tk=tk, params=params, qp=np_tree(jq.quantize_lm_params(params)),
                shift=np_tree(shift), jb=jb, tb=tb, params_t=params_t,
                qp_t=tq.quantize_lm_params(params_t), enc=enc)


def test_lvlm_forward_on_a_quantized_tree_matches_jax(gen_setup):
    s = gen_setup
    assert_same_bytes(s["qp"], s["qp_t"])
    want = jlvlm.lvlm_forward(s["qp"], s["cfg"], s["jb"])
    got = tlvlm.lvlm_forward(s["qp_t"], s["cfg"], s["tb"])
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("with_shift", [False, True], ids=["no-shift", "shift"])
@pytest.mark.parametrize("mode", ["int8", "int8-memory"])
def test_generate_tokens_identical_in_int8_modes(gen_setup, mode, with_shift, num_beams):
    s = gen_setup
    if mode == "int8":   # prefill on the full tree, every decode step on the int8 copy
        jp, jdp, tp, tdp = s["params"], s["qp"], s["params_t"], s["qp_t"]
    else:                # one int8 tree for the prefill and the decode steps
        jp, jdp, tp, tdp = s["qp"], None, s["qp_t"], None
    common = dict(max_new_tokens=NEW_TOKENS, eos_token_id=s["tk"].eos_token_id,
                  pad_token_id=s["tk"].pad_token_id, logz2="unmasked", attn_impl="xla")
    jshift = s["shift"] if with_shift else None
    tshift = to_torch(s["shift"], "cpu") if with_shift else None
    if num_beams == 1:
        want = jg.greedy_generate(jp, s["cfg"], s["jb"], shift=jshift, decode_params=jdp, **common)
        got = tg.greedy_generate(tp, s["cfg"], s["tb"], shift=tshift, decode_params=tdp, **common)
    else:
        want = jg.beam_generate(jp, s["cfg"], s["jb"], num_beams=num_beams, shift=jshift,
                                decode_params=jdp, **common)
        got = tg.beam_generate(tp, s["cfg"], s["tb"], num_beams=num_beams, shift=tshift,
                               decode_params=tdp, **common)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# runner modes, factory, bridge
# ---------------------------------------------------------------------------


def _runner(quant=None):
    return build_model("tiny-idefics2", device="cpu", dtype=torch.float32, seed=0, quant=quant)


def test_runner_dual_copy_leaves_the_main_tree():
    r = _runner("int8")
    layers = r.decode_params["lm"]["decoder"]["layers"]
    assert tq.is_quantized(layers["qkv_proj"]) and tq.is_quantized(layers["gateup_proj"])
    assert layers["qkv_proj"]["scale"].dtype == torch.float32
    main = r.params["lm"]["decoder"]["layers"]
    assert not tq.is_quantized(main["q_proj"]) and "qkv_proj" not in main
    # the unquantized tensors of the copy are the main tree's
    assert layers["input_ln"] is main["input_ln"]
    r.set_quant(None)
    assert r.decode_params is None


def test_runner_memory_mode_is_idempotent_and_rejects_bad_modes():
    r = _runner("int8-memory")
    assert r.decode_params is None
    layers = r.params["lm"]["decoder"]["layers"]
    assert tq.is_quantized(layers["qkv_proj"]) and "q_proj" not in layers
    # the module holds the int8 text tower only: its full-precision stacks are gone
    assert not any(name.startswith("lm/") and name.endswith(("_proj", "lm_head"))
                   for name, _ in r.module.named_buffers())
    before = {k: v for k, v in r.module.named_buffers()}
    r.set_quant("int8-memory")
    assert all(v is before[k] for k, v in r.module.named_buffers())
    with pytest.raises(ValueError):
        r.set_quant("int8")
    with pytest.raises(ValueError):
        r.set_quant("fp4")
    # on a tree that is already int8 "int8-w8a8" re-marks nothing (as in JAX)
    r.set_quant("int8-w8a8")
    assert all(v is before[k] for k, v in r.module.named_buffers())
    assert "a8" not in r.params["lm"]["decoder"]["layers"]["qkv_proj"]
    with pytest.raises(ValueError):
        _runner("fp4")


@pytest.mark.parametrize("mode", ["int8", "int8-memory"])
def test_runner_generate_matches_jax_runner_in_int8_modes(gen_setup, mode):
    s = gen_setup
    jr = JaxRunner(s["cfg"], s["params"], SimpleTokenizer(), quant=mode)
    jr.set_shift(s["shift"])
    tr = LVLMRunner(s["cfg"], s["params_t"], SimpleTokenizer(), device="cpu", quant=mode)
    tr.set_shift(to_torch(s["shift"], "cpu"))
    for beams in (3, 1):
        want = jr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=NEW_TOKENS)
        got = tr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=NEW_TOKENS)
        assert got == want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["dual-copy", "memory"])
def test_quantized_trees_cross_the_bridge_bit_exactly(mode, dtype):
    _, params, _ = _tiny_lvlm(DTYPES[dtype][0])
    qp = jq.quantize_lm_params(params, act_quant=True)
    tree = qp if mode == "memory" else {"params": params, "decode_params": qp}
    tree = np_tree(tree)
    back = to_numpy(to_torch(tree, "cpu"), bfloat16=jnp.bfloat16)
    a8 = _flat(back)["lm/decoder/layers/qkv_proj/a8"] if mode == "memory" else \
        _flat(back)["decode_params/lm/decoder/layers/qkv_proj/a8"]
    assert a8.dtype == np.int8 and a8.shape == (0,)
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        assert np.array_equal(got[path].view(np.uint8), np.ascontiguousarray(w).view(np.uint8)), path


def test_int8_modes_run_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        import numpy as np, torch
        from mimic_tpu_torch.models.factory import build_model
        from mimic_tpu_torch.ops import quant
        runner = build_model("tiny-idefics2", device="cpu", dtype=torch.float32, seed=0,
                             quant="int8")
        img = np.random.default_rng(0).integers(0, 255, (28, 28, 3)).astype(np.uint8)
        texts = ["Image:<image> Q: what? A:", "Image:<image> Q? A:"]
        a = runner.generate([[img], [img]], texts, num_beams=3, max_new_tokens=4)
        runner.set_quant(None)
        runner.set_quant("int8-memory")
        b = runner.generate([[img], [img]], texts, num_beams=3, max_new_tokens=4)
        assert len(a) == len(b) == 2
        assert quant.is_quantized(runner.params["lm"]["lm_head"])
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        assert not any(m.startswith("mimic_tpu.ops") for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
