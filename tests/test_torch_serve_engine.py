"""mimic_tpu_torch.serve against the JAX package's serve engine, fp32, on the CPU.

Each case of ``tests/test_serve_engine.py`` runs through the JAX engine and
the port on the same ``init_lvlm_params`` tree (carried across by
``bridge.to_torch``) and the same numpy prompts: every request's tokens must
be identical to the JAX engine's and to the port's own unpadded
``greedy_generate``, and the reclamation counters equal JAX's.  The decoder's
per-row cache writes (``cache_write_pos``) are held to the JAX decoder's
within 1e-5, a retired row's dropped write included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import decoder as jd
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops.quant import quantize_lm_params
from mimic_tpu.serve import engine as jeng
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.serve import engine as teng

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Model:
    """A tiny model on both sides: the JAX tree and its torch copy."""

    def __init__(self, family: str, eos_scale: float = 1.0):
        self.tk = tk = SimpleTokenizer(padding_side="left")
        cfg = get_model_config(f"tiny-{family}")
        self.cfg = cfg.replace(
            image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
            bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
            text=cfg.text.__class__(**{**cfg.text.__dict__, "vocab_size": tk.vocab_size}),
        )
        params = jlvlm.init_lvlm_params(self.cfg, jax.random.PRNGKey(0))
        if eos_scale != 1.0:
            # scale the unembedding's EOS column ([D, V]) so EOS wins within a few steps
            head = params["lm"]["lm_head"]
            params["lm"]["lm_head"] = head.at[:, tk.eos_token_id].set(
                head[:, tk.eos_token_id] * eos_scale)
        self.jparams = params
        self.tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")

    def engines(self, jax_kw=None, port_kw=None, **kw):
        """(JAX engine, port engine) with the same arguments."""
        return (jeng.ServeEngine(self.cfg, self.jparams, **kw, **(jax_kw or {})),
                teng.ServeEngine(self.cfg, self.tparams, device="cpu", **kw, **(port_kw or {})))

    def greedy(self, ids, max_new, pixel_values=None, shift=None):
        """The port's unpadded ``greedy_generate`` tokens, cut at EOS."""
        batch = tlvlm.LVLMBatch(
            input_ids=torch.from_numpy(ids[None]).long(),
            attention_mask=torch.ones(1, len(ids), dtype=torch.int32),
            pixel_values=None if pixel_values is None else torch.from_numpy(pixel_values[None]),
            pixel_mask=None if pixel_values is None else torch.ones(
                1, pixel_values.shape[0], dtype=torch.int32),
        )
        out = tg.greedy_generate(
            self.tparams, self.cfg, batch, max_new_tokens=max_new,
            eos_token_id=self.tk.eos_token_id, pad_token_id=self.tk.pad_token_id,
            shift=shift, logz2="masked",
        )
        toks = [int(t) for t in out.tokens[0]]
        eos = self.tk.eos_token_id
        return toks[: toks.index(eos)] if eos in toks else toks


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(family, eos_scale=1.0):
        if (family, eos_scale) not in cache:
            cache[family, eos_scale] = Model(family, eos_scale)
        return cache[family, eos_scale]

    return get


def _prompts(seed, lengths, image_tokens=0, image_id=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        ids = rng.integers(4, 250, size=(n,)).astype(np.int32)
        if image_tokens:
            ids[1 : 1 + image_tokens] = image_id
        out.append(ids)
    return out


def _serve(eng, mod, prompts, max_new, runs=1, **per_request):
    """Submit every prompt (``per_request[name][i]`` as request i's field) and
    run; returns each run's token lists, ordered by uid."""
    outs = []
    for _ in range(runs):
        for i, p in enumerate(prompts):
            extra = {k: v[i] for k, v in per_request.items()}
            eng.submit(mod.ServeRequest(uid=i, input_ids=p, max_new_tokens=max_new, **extra))
        results = eng.run()
        assert [r.uid for r in results] == list(range(len(prompts)))
        outs.append([r.tokens for r in results])
    return outs if runs > 1 else outs[0]


def _check(m, jax_eng, port_eng, prompts, max_new, greedy_kw=None, jax_req=None, port_req=None):
    """Port tokens == JAX engine tokens == the port's unpadded greedy; counters equal."""
    want = _serve(jax_eng, jeng, prompts, max_new, **(jax_req or {}))
    got = _serve(port_eng, teng, prompts, max_new, **(port_req or {}))
    assert got == want
    for i, (toks, p) in enumerate(zip(got, prompts)):
        kw = {k: v[i] for k, v in (greedy_kw or {}).items()}
        assert toks == m.greedy(p, max_new, **kw), (i, toks)
    assert (port_eng.blocks_run, port_eng.reclaimed_blocks) == (
        jax_eng.blocks_run, jax_eng.reclaimed_blocks)
    return got


def test_mixed_lengths_match_jax_and_static_greedy(models):
    m = models("text")
    prompts = _prompts(0, [5, 11, 17, 26, 9, 30])
    # 3 slots < 6 requests: retirement and mid-flight admission
    j, t = m.engines(num_slots=3, max_len=64, prefill_buckets=(8, 16, 32), decode_block=2)
    _check(m, j, t, prompts, 6)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 28, 28, 3)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("family", ["idefics2", "llava-interleave"])
def test_images_match_jax_and_static_greedy(models, family):
    m = models(family)
    prompts = _prompts(1, (7, 13), m.cfg.image_seq_len, m.cfg.image_token_id)
    images = _images(1, 2)
    j, t = m.engines(num_slots=2, max_len=48, prefill_buckets=(16,), decode_block=3)
    _check(m, j, t, prompts, 5, greedy_kw={"pixel_values": images},
           jax_req={"pixel_values": images}, port_req={"pixel_values": images})


def test_precomputed_feats_match_pixels_and_jax(models):
    """Features encoded ahead of submission, as a shared ``(base, row)`` and
    as per-request tensors, decode as the pixels do, on both sides."""
    m = models("idefics2")
    prompts = _prompts(4, (7, 13, 9), m.cfg.image_seq_len, m.cfg.image_token_id)
    images = _images(4, 3)
    kw = dict(num_slots=2, max_len=48, prefill_buckets=(16,), decode_block=3)
    base = tlvlm.encode_images(m.tparams, m.cfg, torch.from_numpy(np.stack(images)))
    jbase = jlvlm.encode_images(m.jparams, m.cfg, jnp.asarray(np.stack(images)), None)
    want = _serve(m.engines(**kw)[0], jeng, prompts, 5,
                  image_feats=[(jbase, i) for i in range(3)])
    assert want == _serve(m.engines(**kw)[0], jeng, prompts, 5, pixel_values=images)
    for feats in ([(base, i) for i in range(3)], [base[i].clone() for i in range(3)]):
        assert _serve(m.engines(**kw)[1], teng, prompts, 5, image_feats=feats) == want
    got = _serve(m.engines(**kw)[1], teng, prompts, 5, pixel_values=images)
    assert got == want
    for toks, p, im in zip(got, prompts, images):
        assert toks == m.greedy(p, 5, pixel_values=im)


def test_mixed_wave_is_rejected(models):
    m = models("idefics2")
    prompts = _prompts(4, (7, 9), m.cfg.image_seq_len, m.cfg.image_token_id)
    images = _images(4, 2)
    feats = tlvlm.encode_images(m.tparams, m.cfg, torch.from_numpy(images[0][None]))[0]
    t = m.engines(num_slots=2, max_len=48, prefill_buckets=(16,))[1]
    t.submit(teng.ServeRequest(uid=0, input_ids=prompts[0], image_feats=feats))
    t.submit(teng.ServeRequest(uid=1, input_ids=prompts[1], pixel_values=images[1]))
    with pytest.raises(ValueError, match="mixes precomputed image_feats"):
        t.run()


def test_shift_active(models):
    m = models("text")
    enc, _ = get_preset("mimic")
    shift = init_shift_params(enc, m.cfg.text, jax.random.PRNGKey(3))
    shift = jax.tree.map(lambda x: x + 0.05 * jnp.ones_like(x), shift)
    tshift = to_torch(jax.tree.map(np.asarray, shift), "cpu")
    prompts = _prompts(2, (9,))
    j, t = m.engines(num_slots=2, max_len=48, prefill_buckets=(16,),
                     jax_kw={"shift": shift}, port_kw={"shift": tshift})
    got = _check(m, j, t, prompts, 5, greedy_kw={"shift": [tshift]})
    assert got[0] != m.greedy(prompts[0], 5)  # the shift changes the tokens


def test_capacity_guard(models):
    m = models("text")
    for eng, mod in zip(m.engines(num_slots=1, max_len=20, prefill_buckets=(16,)), (jeng, teng)):
        with pytest.raises(ValueError, match="capacity"):
            eng.submit(mod.ServeRequest(uid=0, input_ids=np.arange(4, 10, dtype=np.int32),
                                        max_new_tokens=8))


def test_engine_reuse_two_runs(models):
    m = models("text")
    prompts = _prompts(5, (6, 14, 23))
    j, t = m.engines(num_slots=2, max_len=64, prefill_buckets=(8, 16, 32), decode_block=3)
    want = _serve(j, jeng, prompts, 5, runs=2)
    got = _serve(t, teng, prompts, 5, runs=2)
    assert got == want
    assert got[0] == got[1] == [m.greedy(p, 5) for p in prompts]


def test_reclaim_frees_slots_early(models):
    """EOS-heavy model, long budgets: the reader frees slots at EOS, with the
    JAX engine's counters, and the tokens keep their truncation semantics."""
    m = models("text", eos_scale=12.0)
    prompts = _prompts(7, (5, 9, 13, 7, 11, 6))
    max_new = 24  # 12 blocks of 2, mostly reclaimable
    got = {}
    for reclaim in (True, False):
        kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,), decode_block=2, reclaim=reclaim)
        j, t = m.engines(**kw)
        got[reclaim] = _check(m, j, t, prompts, max_new)
        got[reclaim, "engine"] = t
    assert got[True] == got[False]
    assert any(len(toks) < max_new for toks in got[True])
    on, off = got[True, "engine"], got[False, "engine"]
    assert on.reclaimed_blocks > 0 and on.blocks_run < off.blocks_run
    assert off.host_syncs == 1  # without the reader only the final collect waits


def test_duplicate_submission_processed_twice(models):
    m = models("text")
    p = _prompts(8, (9,))[0]
    toks = m.greedy(p, 4)
    for eng, mod in zip(m.engines(num_slots=1, max_len=32, prefill_buckets=(16,)), (jeng, teng)):
        req = mod.ServeRequest(uid=0, input_ids=p, max_new_tokens=4)
        eng.submit(req)
        eng.submit(req)
        assert [r.tokens for r in eng.run()] == [toks, toks]


def test_engine_max_new_one(models):
    m = models("text")
    prompts = _prompts(6, (5, 9, 12))
    j, t = m.engines(num_slots=1, max_len=40, prefill_buckets=(16,))
    _check(m, j, t, prompts, 1)
    assert t.blocks_run == 0


def test_int8_decode_params_match_jax(models):
    """int8 ``decode_params`` (the plain versions of int8_matmul and the
    two-qdot MLP on the CPU) give the JAX engine's tokens on the same handles."""
    m = models("text")
    jq = quantize_lm_params(m.jparams)
    tq = to_torch(jax.tree.map(np.asarray, jq), "cpu")
    prompts = _prompts(9, (5, 11, 17, 26))
    j, t = m.engines(num_slots=2, max_len=64, prefill_buckets=(8, 16, 32), decode_block=2,
                     jax_kw={"decode_params": jq}, port_kw={"decode_params": tq})
    want = _serve(j, jeng, prompts, 6)
    assert _serve(t, teng, prompts, 6) == want


def test_idefics1_is_rejected():
    cfg = get_model_config("tiny-idefics1")
    with pytest.raises(ValueError, match="cross-attention"):
        teng.ServeEngine(cfg, {}, device="cpu")


def test_default_device_is_the_card(models):
    m = models("text")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.ServeEngine(m.cfg, m.tparams)


# ---------------------------------------------------------------------------
# the decoder's per-row cache writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad", [False, True], ids=["in-place", "recorded"])
def test_cache_write_pos_matches_jax(grad):
    """One decode step of three slots at their own columns of a full-width
    cache (``length`` = max_len); the last slot sits at max_len, a retired
    slot whose write is dropped.  Logits-side hidden states and the cache
    within 1e-5 of JAX; the written rows changed, nothing else did."""
    cfg = tiny_text("idefics2").text
    params = jax.tree.map(np.asarray, jd.init_decoder_params(cfg, jax.random.PRNGKey(0)))
    B, S = 3, 12
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_size)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    step = rng.normal(size=(B, 1, cfg.hidden_size)).astype(np.float32)
    write_pos = np.array([4, 9, S], np.int32)
    key_mask = np.zeros((B, S + 1), np.int32)
    for b, (lo, p) in enumerate(zip((1, 0, 3), write_pos)):
        key_mask[b, lo:p] = 1
    key_mask[:, S] = 1  # the current token's column
    rpos = np.array([[3], [9], [7]], np.int32)

    j = jnp.asarray
    ref = jd.decoder_forward(
        params, cfg, j(step), None, j(rpos),
        kv_cache={"k": j(ck), "v": j(cv), "length": j(S)}, key_mask=j(key_mask),
        cache_write_pos=j(write_pos),
    )
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()), "length": S}
    x = torch.from_numpy(step).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = td.decoder_forward(
            to_torch(params, "cpu"), cfg, x, None, torch.from_numpy(rpos).long(),
            kv_cache=cache, key_mask=torch.from_numpy(key_mask),
            cache_write_pos=torch.from_numpy(write_pos),
        )
    assert out.kv_cache["length"] == S
    assert (out.kv_cache["k"] is cache["k"]) is not grad  # in place only without gradients
    np.testing.assert_allclose(out.hidden.detach().numpy(), np.asarray(ref.hidden),
                               rtol=TOL, atol=TOL)
    for name, before in (("k", ck), ("v", cv)):
        got = out.kv_cache[name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(ref.kv_cache[name]), rtol=TOL, atol=TOL)
        changed = np.argwhere((got != before).any(axis=(0, 3, 4)))
        assert changed.tolist() == [[0, 4], [1, 9]]  # row 2's write at max_len is dropped
    if grad:
        out.hidden.sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()


def test_cache_write_pos_needs_one_token_step():
    cfg = tiny_text("idefics2").text
    params = td.init_decoder_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = td.init_kv_cache(cfg, 1, 8, "cpu")
    cache["length"] = 8
    with pytest.raises(ValueError, match="one-token step"):
        td.decoder_forward(params, cfg, torch.zeros(1, 2, cfg.hidden_size), None,
                           torch.zeros(1, 2, dtype=torch.long), kv_cache=cache,
                           cache_write_pos=torch.zeros(1, dtype=torch.long))
