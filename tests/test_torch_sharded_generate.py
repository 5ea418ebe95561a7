"""Generation with the frozen tower sharded over ``model`` (tensor-parallel
serving), the counterpart of ``tests/test_sharded_generate.py``.

Four ``gloo`` processes as a (data 2 x model 2) mesh, each with its
``shard_params`` tree and its ``shard_batch`` rows under ``use_mesh``:
greedy and beam-3 tokens identical to single-device JAX, beam scores within
1e-5 (the beam-shared prompt cache at B and the generated region at B·K hold
this rank's KV heads); the serve engine on tiny-text gives the tokens of the
unsharded engine, as ``__graft_entry__.py::dryrun_multichip`` holds JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models.config import get_model_config as port_model_config
from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest
from torch_dist import run_world


def _spec(name, tk):
    top = dict(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
               bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return name, top, {"vocab_size": tk.vocab_size}


def _cfg(spec, get=get_model_config):
    name, top, text = spec
    cfg = get(name).replace(**top)
    return cfg.replace(text=dataclasses.replace(cfg.text, **text))


def _engine_tokens(cfg, params, prompts):
    eng = ServeEngine(cfg, params, num_slots=2, max_len=48, prefill_buckets=(8, 16, 32),
                      decode_block=2, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
    return [r.tokens for r in eng.run()]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tk = SimpleTokenizer(padding_side="left")
    spec = _spec("tiny-idefics2", tk)
    cfg = _cfg(spec)
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(3, 250, size=(4, 16)).astype(np.int32),
             "attention_mask": np.ones((4, 16), np.int32)}
    batch["attention_mask"][1, :5] = 0  # a left-padded row
    engine_spec = _spec("tiny-text", tk)
    engine_params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(
        _cfg(engine_spec), jax.random.PRNGKey(3)))
    prompts = [np.random.default_rng(9).integers(4, 250, size=(n,)).astype(np.int32)
               for n in (6, 11, 17)]
    inputs = {"spec": spec, "params": params, "batch": batch, "eos": tk.eos_token_id,
              "pad": tk.pad_token_id, "engine_spec": engine_spec,
              "engine_params": engine_params, "prompts": prompts}
    outs = run_world("torch_workers:generate_world", 4, tmp_path_factory.mktemp("generate"),
                     inputs)
    return cfg, params, batch, tk, inputs, outs


def _jax_batch(batch):
    return jlvlm.LVLMBatch(**{k: jnp.asarray(v) for k, v in batch.items()})


def test_model_parallel_greedy_matches_single(world):
    cfg, params, batch, tk, _, outs = world
    want = np.asarray(jg.greedy_generate(params, cfg, _jax_batch(batch), 4, tk.eos_token_id,
                                         tk.pad_token_id).tokens)
    for rank, out in enumerate(outs):
        d = rank // 2
        np.testing.assert_array_equal(out["greedy"], want[2 * d:2 * d + 2])


def test_model_parallel_beam_matches_single(world):
    cfg, params, batch, tk, _, outs = world
    want = jg.beam_generate(params, cfg, _jax_batch(batch), 4, 3, tk.eos_token_id,
                            tk.pad_token_id)
    for rank, out in enumerate(outs):
        d = rank // 2
        np.testing.assert_array_equal(out["beam"], np.asarray(want.tokens)[2 * d:2 * d + 2])
        np.testing.assert_allclose(out["beam_scores"], np.asarray(want.scores)[2 * d:2 * d + 2],
                                   rtol=1e-5, atol=1e-5)


def test_serve_engine_sharded_tokens_equal_unsharded(world):
    *_, inputs, outs = world
    tcfg = _cfg(inputs["engine_spec"], port_model_config)
    with torch.no_grad():
        want = _engine_tokens(tcfg, to_torch(inputs["engine_params"], "cpu"), inputs["prompts"])
    assert all(len(t) > 0 for t in want)
    for out in outs:
        assert out["engine"] == want
        assert out["cache_heads"] == tcfg.text.num_kv_heads // 2  # this rank's KV heads
