"""The serving slice as a whole: mimic_tpu_torch generation against the JAX package.

A tiny idefics2 with a MimIC shift (``logz2="unmasked"``) on a left-padded
text+image batch, parameters carried across by the bridge.  In fp32, greedy
and beam-3 tokens must be identical to ``mimic_tpu.models.generate`` and the
prefill's last logits agree within rtol/atol 1e-4.  Two configurations: the
default tiny tower (plain attention) and head_dim 128 on a 128-token prompt,
where both packages take the ``"flash"`` prefill path.
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
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.runner import LVLMRunner

TOL = 1e-4
TEXTS = [
    "Image:<image> Question: what is shown? Answer:",
    "Image:<image> Question: a much longer question about the picture here? Answer:",
]


def _cfg(flash: bool, tk: SimpleTokenizer):
    cfg = tiny_text("idefics2", head_dim=128) if flash else get_model_config("tiny-idefics2")
    cfg = cfg.replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )
    return cfg.replace(text=cfg.text.__class__(**{**cfg.text.__dict__, "vocab_size": tk.vocab_size}))


def _images(n=2):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(n)]


@pytest.fixture(scope="module", params=[False, True], ids=["xla", "flash"])
def slice_setup(request):
    flash = request.param
    tk = SimpleTokenizer(padding_side="left")
    cfg = _cfg(flash, tk)
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    enc_cfg, _ = get_preset("mimic")
    shift = init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(1))
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    shift = jax.tree.map(np.asarray, shift)
    enc = LVLMProcessor(cfg, tk)(_images(), TEXTS, pad_to=128 if flash else None)
    attn_impl = "flash" if flash else "xla"
    return cfg, tk, params, shift, enc, attn_impl


def _batches(enc):
    jb = jlvlm.LVLMBatch(
        input_ids=jnp.asarray(enc["input_ids"]), attention_mask=jnp.asarray(enc["attention_mask"]),
        pixel_values=jnp.asarray(enc["pixel_values"]), pixel_mask=jnp.asarray(enc["pixel_mask"]),
        patch_mask=jnp.asarray(enc["patch_mask"]),
    )
    tb = tlvlm.LVLMBatch(
        input_ids=torch.from_numpy(enc["input_ids"]).long(),
        attention_mask=torch.from_numpy(enc["attention_mask"]),
        pixel_values=torch.from_numpy(enc["pixel_values"]),
        patch_mask=torch.from_numpy(enc["patch_mask"]),
    )
    return jb, tb


def test_prefill_last_logits_match(slice_setup):
    cfg, tk, params, shift, enc, attn_impl = slice_setup
    assert enc["attention_mask"][0, 0] == 0  # left-padded rows present
    jb, tb = _batches(enc)
    T = enc["input_ids"].shape[1]
    ref, _, _ = jg._prefill(params, cfg, jb, T + 3, shift, None, 1.0, "unmasked",
                            jnp.float32, attn_impl)
    td.ATTN_PATH_LOG.clear()
    got, cache, _ = tg._prefill(to_torch(params, "cpu"), cfg, tb, T + 3,
                                to_torch(shift, "cpu"), "unmasked", torch.float32, attn_impl)
    assert td.ATTN_PATH_LOG == [attn_impl]
    assert cache["length"] == T
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_generate_tokens_identical(slice_setup, num_beams):
    cfg, tk, params, shift, enc, attn_impl = slice_setup
    jb, tb = _batches(enc)
    common = dict(max_new_tokens=6, eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id,
                  logz2="unmasked", attn_impl=attn_impl)
    params_t, shift_t = to_torch(params, "cpu"), to_torch(shift, "cpu")
    if num_beams == 1:
        ref = jg.greedy_generate(params, cfg, jb, shift=shift, **common)
        got = tg.greedy_generate(params_t, cfg, tb, shift=shift_t, **common)
    else:
        ref = jg.beam_generate(params, cfg, jb, num_beams=num_beams, shift=shift, **common)
        got = tg.beam_generate(params_t, cfg, tb, num_beams=num_beams, shift=shift_t, **common)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_top_k_ties_break_like_jax():
    x = np.array([[0.5, -1e9, 0.5, -1e9, 2.0, -1e9, -1e9]], np.float32)
    vals, idx = tg._top_k(torch.from_numpy(x), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_runner_generate_matches_jax_runner():
    tk_t = SimpleTokenizer()
    tk_j = SimpleTokenizer()
    cfg = _cfg(False, tk_t)
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(3)))
    enc_cfg, _ = get_preset("mimic")
    shift = jax.tree.map(np.asarray, init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(4)))
    jr = JaxRunner(cfg, params, tk_j)
    jr.set_shift(shift)
    tr = LVLMRunner(cfg, to_torch(params, "cpu"), tk_t, device="cpu")
    tr.set_shift(to_torch(shift, "cpu"))
    for beams in (3, 1):
        want = jr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=5)
        got = tr.generate(_images(), TEXTS, num_beams=beams, max_new_tokens=5)
        assert got == want
    assert tk_t.padding_side == "right"  # restored after generate


def test_slice_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        import numpy as np, torch
        from mimic_tpu_torch.config import get_preset
        from mimic_tpu_torch.models.factory import build_model
        from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
        from mimic_tpu_torch.shift.params import init_shift_params
        runner = build_model("tiny-idefics2", device="cpu", dtype=torch.float32, seed=0)
        enc_cfg, _ = get_preset("mimic")
        g = torch.Generator().manual_seed(1)
        runner.set_shift(init_shift_params(enc_cfg, runner.cfg.text, g, torch.device("cpu")))
        img = np.random.default_rng(0).integers(0, 255, (28, 28, 3)).astype(np.uint8)
        out = runner.generate([[img], [img]], ["Image:<image> Q: what? A:", "Image:<image> Q? A:"],
                              num_beams=3, max_new_tokens=4)
        assert len(out) == 2 and all(isinstance(s, str) for s in out)
        assert ATTN_PATH_LOG[0] == "xla" and ATTN_PATH_LOG[1:] == ["cached"] * 3
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        assert not any(m.startswith("mimic_tpu.ops") or m.startswith("mimic_tpu.train")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
