"""The W8A8 half of mimic_tpu_torch.ops.quant and the ``"int8-w8a8"`` serving
mode against the JAX package.  Same numpy inputs on both sides; each test
states its tolerance.

- ``quantize_rows``: bit-identical to ``jax.jit(quantize_rows)`` (how the TPU
  forward runs it: XLA multiplies by fp32 1/127 there); against the eager JAX
  function the scales agree to one fp32 ulp and the int8 rows to one step.
- ``w8a8_matmul_plain`` and the stacked form against the Pallas kernels in
  interpret mode: fp32 out within 1e-6 relative (both are exact integer sums
  scaled twice).
- ``qdot`` on an ``a8`` handle on the CPU: the dequantized product, as JAX's.
- The gradient of the W8A8 Function against ``jax.vjp`` of ``_input_vjp``.
- ``set_quant("int8-w8a8")``: the tree, markers included, bit-identical to the
  JAX runner's; greedy and beam-3 tokens identical in fp32, with and without
  a shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops import quant as jq
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops import quant as tq
from test_torch_quant import (DTYPES, TEXTS, _images, _t, _tiny_lvlm, _weight, assert_same_bytes,
                              np_tree)

TOL_EXACT = 1e-6   # two exact integer sums, each scaled twice in fp32
TOL_FP32 = 1e-5
NEW_TOKENS = 5


def _rows(shape, seed, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if spread:  # rows of very different magnitude, so the scales differ widely
        x *= rng.uniform(0.01, 30.0, size=shape[:-1] + (1,)).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# quantize_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(512, 256), (4, 37, 96), (300, 4096)], ids=str)
def test_quantize_rows_matches_jitted_jax_bit_for_bit(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(_rows(shape, 1)).astype(jdt)
    want8, wants = jax.jit(jq.quantize_rows)(x)
    got8, gots = tq.quantize_rows(to_torch(np.asarray(x), "cpu"))
    assert got8.dtype == torch.int8 and gots.dtype == torch.float32
    assert got8.shape == shape and gots.shape == shape[:-1]
    assert np.array_equal(got8.numpy(), np.asarray(want8))
    assert np.array_equal(gots.numpy().view(np.uint32), np.asarray(wants).view(np.uint32))


def test_quantize_rows_follows_the_jitted_function_where_eager_jax_differs():
    """Op by op, JAX divides amax by 127; under jit XLA multiplies by the fp32
    constant 1/127.  The two scales differ by one ulp in some rows, and the
    port follows the jitted one: the TPU forward always runs jitted."""
    x = jnp.asarray(_rows((4096, 128), 2))
    eager8, eagers = (np.asarray(a) for a in jq.quantize_rows(x))
    jit8, jits = (np.asarray(a) for a in jax.jit(jq.quantize_rows)(x))
    got8, gots = (a.numpy() for a in tq.quantize_rows(_t(np.asarray(x))))
    differ = eagers != jits
    assert 0 < differ.sum() < 0.2 * differ.size  # the two really differ, in a minority of rows
    assert np.array_equal(gots, jits) and np.array_equal(got8, jit8)
    # against the eager function: one ulp on the scale, at most one int8 step
    ulp = np.abs(eagers.view(np.int32).astype(np.int64) - gots.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    assert np.abs(eager8.astype(np.int32) - got8.astype(np.int32)).max() <= 1


def test_quantize_rows_zero_rows_and_the_127_property():
    x8, xs = tq.quantize_rows(torch.zeros(3, 16))
    assert torch.isfinite(xs).all() and int(x8.abs().sum()) == 0
    assert np.array_equal(xs.numpy(), np.asarray(jax.jit(jq.quantize_rows)(jnp.zeros((3, 16)))[1]))
    x = _t(_rows((64, 128), 3))
    x8, xs = tq.quantize_rows(x)
    # every row's largest element lands on +-127, and the rounding error is half a step
    assert int(x8.abs().amax(dim=-1).min()) == 127 and int(x8.abs().max()) == 127
    err = (x8.float() * xs[:, None] - x).abs()
    assert bool((err <= xs[:, None] * 0.5 + 1e-7).all())


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _w8a8_inputs(m, k, n, seed, layers=0, act_quant=True):
    x = _rows((m, k), seed, spread=False)
    w = _weight((layers, k, n) if layers else (k, n), seed + 1)
    q = jq.quantize_weight(jnp.asarray(w), act_quant=act_quant)
    x8, xs = jax.jit(jq.quantize_rows)(jnp.asarray(x))
    return x8, xs, q


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 256, 384)])
def test_w8a8_plain_matches_pallas_interpret(m, k, n):
    x8, xs, q = _w8a8_inputs(m, k, n, 10)
    want = jq.w8a8_matmul(x8, xs, q["q8"], q["scale"], out_dtype=jnp.float32,
                          block_m=128, block_n=128, block_k=128, interpret=True)
    args = (_t(x8), _t(xs), _t(q["q8"]), _t(q["scale"]))
    got = tq.w8a8_matmul_plain(*args, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_EXACT, atol=0)
    # the public wrapper takes the plain version for CPU tensors
    assert torch.equal(tq.w8a8_matmul(*args, out_dtype=torch.float32), got)
    # bf16 out (the default): one rounding of the same fp32 value
    want16 = jq.w8a8_matmul(x8, xs, q["q8"], q["scale"], block_m=128, block_n=128, block_k=128,
                            interpret=True)
    got16 = tq.w8a8_matmul(*args)
    assert got16.dtype == torch.bfloat16
    assert np.array_equal(got16.view(torch.int16).numpy(),
                          np.asarray(want16).view(np.int16))


@pytest.mark.parametrize("layer", [0, 2])
def test_w8a8_stacked_plain_matches_pallas_interpret(layer):
    x8, xs, q = _w8a8_inputs(128, 128, 256, 11, layers=3)
    want = jq.w8a8_matmul_stacked(x8, xs, q["q8"], q["scale"], jnp.int32(layer),
                                  out_dtype=jnp.float32, block_m=128, block_n=128, block_k=128,
                                  interpret=True)
    got = tq.w8a8_matmul_stacked(_t(x8), _t(xs), _t(q["q8"]), _t(q["scale"]), layer,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_EXACT, atol=0)
    other = tq.w8a8_matmul_stacked(_t(x8), _t(xs), _t(q["q8"]), _t(q["scale"]), 1,
                                   out_dtype=torch.float32)
    assert not torch.equal(got, other)


def test_w8a8_plain_ragged_m_and_padded_n_match_pallas_interpret():
    """M that is no multiple of a block (the port's kernel masks it; the TPU
    path pads M to 128, so the reference runs on the padded rows) and a
    lane-padded N (storage 256 for N 200: scale padded, output sliced)."""
    x8, xs, q = _w8a8_inputs(200, 128, 200, 12)
    assert q["q8"].shape == (128, 256)
    scale = jnp.pad(q["scale"], (0, 56))
    x8p, xsp = jnp.pad(x8, ((0, 56), (0, 0))), jnp.pad(xs, (0, 56))
    want = jq.w8a8_matmul(x8p, xsp, q["q8"], scale, out_dtype=jnp.float32, block_m=128,
                          block_n=128, block_k=128, interpret=True)[:200, :200]
    got = tq.w8a8_matmul(_t(x8), _t(xs), _t(q["q8"]), _t(scale), out_dtype=torch.float32)
    assert got.shape == (200, 256) and float(got[:, 200:].abs().max()) == 0.0
    np.testing.assert_allclose(got[:, :200].numpy(), np.asarray(want), rtol=TOL_EXACT, atol=0)


def test_w8a8_plain_sums_exactly_where_float32_and_int8_would_not():
    """K = 4096 at full-scale values passes 2^24: a float32 sum would round and
    an int8 matmul would wrap around; the plain version's sum is exact."""
    K = 4096
    x8 = torch.full((2, K), 127, dtype=torch.int8)
    x8[1, ::2] = -127
    wq = torch.full((K, 16), 127, dtype=torch.int8)
    wq[1::3, 5] = 126
    ones = torch.ones(2), torch.ones(16)
    got = tq.w8a8_matmul_plain(x8, ones[0], wq, ones[1], torch.float32)
    want = (x8.to(torch.int64) @ wq.to(torch.int64)).float()  # int64 → fp32: one rounding
    assert torch.equal(got, want)
    assert int(want.abs().max()) == 127 * 127 * K > 2**24


# ---------------------------------------------------------------------------
# qdot and the gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_qdot_ignores_the_a8_marker_on_the_cpu_as_jax_does(stacked):
    x = _rows((300, 64), 13, spread=False)
    w = _weight((3, 64, 200) if stacked else (64, 200), 14)
    qa = jq.quantize_weight(jnp.asarray(w), act_quant=True)
    ta = tq.quantize_weight(_t(w), act_quant=True)
    assert "a8" in ta and ta["a8"].numel() == 0 and ta["a8"].dtype == torch.int8
    assert_same_bytes(qa, ta)
    if stacked:
        qa, ta = dict(qa, layer=jnp.int32(1)), dict(ta, layer=1)
    before = dict(tq.LAUNCHES)
    got = tq.qdot(_t(x), ta)
    assert tq.LAUNCHES == before
    # the dequantized fp32 product, not the W8A8 one
    deq = tq.dequantize(ta)
    assert torch.equal(got, _t(x) @ deq)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.qdot(jnp.asarray(x), qa)),
                               rtol=TOL_FP32, atol=TOL_FP32)
    # and the same as without the marker
    plain = {k: v for k, v in ta.items() if k != "a8"}
    assert torch.equal(got, tq.qdot(_t(x), plain))
    # the W8A8 product is close to it but not equal: the rows round too
    x8, xs = tq.quantize_rows(_t(x))
    scale = torch.nn.functional.pad(ta["scale"], (0, 56))
    w8a8 = (tq.w8a8_matmul_stacked(x8, xs, ta["q8"], scale, 1, out_dtype=torch.float32) if stacked
            else tq.w8a8_matmul(x8, xs, ta["q8"], scale, out_dtype=torch.float32))[:, :200]
    err = (w8a8 - got).abs().max() / got.abs().max()
    assert 0 < float(err) < 0.02


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_w8a8_gradient_matches_jax_input_vjp(stacked):
    """``W8A8MatmulDiff``: forward the W8A8 product, backward the
    straight-through ``dY @ deq(W)T`` of JAX's ``_input_vjp``."""
    m, k, n = 128, 128, 256
    x = _rows((m, k), 15, spread=False)
    w = _weight((3, k, n) if stacked else (k, n), 16)
    g = np.random.default_rng(17).normal(size=(m, n)).astype(np.float32)
    q = jq.quantize_weight(jnp.asarray(w), act_quant=True)
    layer = jnp.int32(2) if stacked else None

    def run_w8a8(xm):
        x8, xs = jq.quantize_rows(xm)
        kw = dict(out_dtype=jnp.float32, block_m=128, block_n=128, block_k=128, interpret=True)
        if stacked:
            return jq.w8a8_matmul_stacked(x8, xs, q["q8"], q["scale"], layer, **kw)
        return jq.w8a8_matmul(x8, xs, q["q8"], q["scale"], **kw)

    f = jax.jit(jq._input_vjp(run_w8a8, q["q8"], q["scale"], layer))
    want_out, pull = jax.vjp(f, jnp.asarray(x))
    (want_dx,) = pull(jnp.asarray(g))

    xt = _t(x).requires_grad_(True)
    out = tq.w8a8_matmul_diff(xt, _t(q["q8"]), _t(q["scale"]), 2 if stacked else None,
                              torch.float32)
    assert type(out.grad_fn).__name__ == "W8A8MatmulDiffBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=TOL_EXACT, atol=0)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=TOL_FP32, atol=TOL_FP32)
    # it shares Int8MatmulDiff's backward
    assert tq.W8A8MatmulDiff.backward is tq.Int8MatmulDiff.backward


# ---------------------------------------------------------------------------
# trees and the runner mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_act_quant_trees_match_jax_through_the_bridge(dtype):
    _, params, _ = _tiny_lvlm(DTYPES[dtype][0])
    want = jq.quantize_lm_params(params, act_quant=True)
    got = tq.quantize_lm_params(to_torch(params, "cpu"), act_quant=True)
    assert_same_bytes(want, got)
    layers = got["lm"]["decoder"]["layers"]
    marked = sorted(k for k, v in layers.items() if tq.is_quantized(v) and "a8" in v)
    assert marked == ["down_proj", "gateup_proj", "o_proj", "qkv_proj"]
    assert "a8" not in got["lm"]["lm_head"]
    # mark_act_quant on the weight-only tree gives the same tree
    assert_same_bytes(want, tq.mark_act_quant(tq.quantize_lm_params(to_torch(params, "cpu"))))
    # and the JAX tree crosses the bridge with its markers
    assert_same_bytes(want, to_torch(np_tree(want), "cpu"))


@pytest.fixture(scope="module")
def runners():
    cfg, params, _ = _tiny_lvlm()
    enc_cfg, _ = get_preset("mimic")
    shift = np_tree(init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(1)))
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    jr = JaxRunner(cfg, params, SimpleTokenizer(), quant="int8-w8a8")
    tr = LVLMRunner(cfg, to_torch(params, "cpu"), SimpleTokenizer(), device="cpu",
                    quant="int8-w8a8")
    return jr, tr, shift


def test_set_quant_w8a8_tree_matches_the_jax_runner(runners):
    jr, tr, _ = runners
    assert tr.decode_params is None and jr.decode_params is None
    assert_same_bytes(jr.params, tr.params)
    layers = tr.params["lm"]["decoder"]["layers"]
    assert "a8" in layers["qkv_proj"] and "q_proj" not in layers
    # applying a single-copy mode again changes nothing, in either package
    before = {k: v for k, v in tr.module.named_buffers()}
    for mode in ("int8-w8a8", "int8-memory"):
        tr.set_quant(mode)
        jr.set_quant(mode)
        assert all(v is before[k] for k, v in tr.module.named_buffers())
        assert_same_bytes(jr.params, tr.params)
    with pytest.raises(ValueError):
        tr.set_quant("int8")


@pytest.mark.parametrize("with_shift", [False, True], ids=["no-shift", "shift"])
@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_w8a8_runner_tokens_match_jax(runners, beams, with_shift):
    jr, tr, shift = runners
    jr.set_shift(shift if with_shift else None)
    tr.set_shift(to_torch(shift, "cpu") if with_shift else None)
    want = jr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=NEW_TOKENS)
    got = tr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=NEW_TOKENS)
    assert got == want
