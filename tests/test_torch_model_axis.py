"""Ring attention and int8 weight handles under a ``model`` axis, against
single-device JAX, where GSPMD runs the same layouts.

Without processes: ``tp.head_region`` on the facts its callers pass (int8
handles, a ring over ``model``, the KV heads of the call's cache), and
``make_decode_mask`` against JAX's.

One module-scoped world of four ``gloo`` processes, in fp32, each rank with a
copy of its ``shard_params`` tree and its ``shard_batch`` rows:

- **The ring with a model axis** (``attn_impl="ring"``, ``ring_min_len`` 0,
  both passes of the MimIC step on the ring).  tiny-idefics2 (whose text
  tower is tiny-text's: 4 heads on 2 KV heads of 16) on a ("data", "sp",
  "model") mesh of (1, 2, 2): model 2 leaves each rank whole heads, and each
  rank's ring over ``sp`` runs its own heads; the same tower with one KV head,
  whose k/v model 2 cuts inside the head: the ring runs over every head,
  gathered; tiny-idefics2 at (2, 1, 2), the batch split over ``data``; and
  ``ring_axis="model"`` on ``make_mesh(1, 4)`` with 4 KV heads, where model 4
  would leave each rank one whole head but the ring over ``model`` gathers
  them.  ``lvlm_forward`` with images and the multi-head MimIC shift
  (``logz2`` unmasked and masked: the ring's lse_u and lse), its logits and
  every layer's attention output at the real tokens' rows within 2e-4; one ``mimic`` step's metrics
  and trainables within 1e-5; the shift leaves' gradients within 1e-5 of
  each leaf's norm (summed over ``data`` as the step sums them).
- **int8 handles under model > 1.**  ``LVLMRunner(quant=...)`` on the rank's
  ``shard_params`` tree under ``make_mesh(1, 4)`` and ``make_mesh(2, 2)``, in
  ``"int8"``, ``"int8-memory"`` and ``"int8-w8a8"``, on tiny-idefics2 and a
  Qwen2-shaped tiny llava-interleave tower (7 query heads on 1 KV head of 16,
  q/k/v biases, which the rules split beside a whole fused handle): every
  handle bit-identical to JAX's ``quantize_lm_params`` of the whole tree;
  greedy and beam-3 tokens identical to JAX's, beam scores and logits within
  1e-5.  One beam case with a prompt over ``QUANT_KV_MIN_PROMPT`` (on the CPU
  the prompt KV stays as it is, as JAX's off the TPU).  The serve engine with
  the ``"int8"`` runner's trees at model 4 gives the one-process engine's
  tokens.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mimic_tpu.config import config_to_dict, get_preset
from mimic_tpu.models import decoder as jd
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops import quant as jq
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu.train.step import compute_loss as jax_compute_loss
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch import parallel
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import config as port_configs
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models.generate import QUANT_KV_MIN_PROMPT
from mimic_tpu_torch.ops import quant as tq
from mimic_tpu_torch.parallel import tp
from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest
from mimic_tpu_torch.shift import params as tsp
from test_torch_head_split import StandIn, _cfg, _images, _jax_step, _params, _step_case
from torch_dist import run_world

TOL = 1e-5
NEW = 4

# key → (model name, text fields beside the tokenizer's vocab)
MODELS = {
    "idefics2": ("tiny-idefics2", {}),
    "idefics2-kv1": ("tiny-idefics2", {"num_kv_heads": 1}),
    "idefics2-mha": ("tiny-idefics2", {"num_kv_heads": 4}),
    "qwen": ("tiny-llava-interleave", {"num_heads": 7, "num_kv_heads": 1, "hidden_size": 112}),
}
FIELDS = {"idefics2": ("input_ids", "attention_mask", "pixel_values", "patch_mask")}
# case → (model, mesh, ring axis)
RING = {
    "sp2-whole-heads": ("idefics2", (1, 2, 2), "sp"),
    "sp2-gathered": ("idefics2-kv1", (1, 2, 2), "sp"),
    "data2": ("idefics2", (2, 1, 2), "sp"),
    "ring-over-model": ("idefics2-mha", (1, 4), "model"),
}
MODES = ("int8", "int8-memory", "int8-w8a8")
INT8 = {f"{key}-{m[0]}x{m[1]}-{mode}": (key, m, mode)
        for key in ("idefics2", "qwen") for m in ((1, 4), (2, 2)) for mode in MODES}
LONG = "qwen-1x4-int8-long"


def _spec(key, tk):
    name, text = MODELS[key]
    top = dict(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
               bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return name, top, {"vocab_size": tk.vocab_size, **text}


def _image_batch(cfg, tk):
    """Four rows with an image each, padded to a multiple of 16 tokens, so that
    the sequence splits over every ring here."""
    texts = [f"Image:<image> what is shown in picture {i}? Answer:" for i in range(4)]
    T = LVLMProcessor(cfg, tk)(None, texts)["input_ids"].shape[1]
    enc = LVLMProcessor(cfg, tk)(_images(4), texts, pad_to=-(-T // 16) * 16)
    return {k: np.asarray(enc[k]) for k in FIELDS[cfg.family] if enc.get(k) is not None}


def _text_batch(B, T, pad, seed):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(3, 250, size=(B, T)).astype(np.int32),
             "attention_mask": np.ones((B, T), np.int32)}
    batch["attention_mask"][1, :pad] = 0  # a left-padded row
    return batch


def _jax_batch(batch):
    return jlvlm.LVLMBatch(**{k: jnp.asarray(v) for k, v in batch.items()})


def _quantized(params, mode):
    return jax.tree.map(np.asarray, jq.quantize_lm_params(params, act_quant=mode == "int8-w8a8"))


def _ring_forward(cfg, params, spec, devices):
    """JAX's ring of as many virtual devices on the whole tree (a ring's
    numerics depend on its chunks alone): by logz2, (logits, attention outputs)."""
    m = spec["mesh"]
    n = m[1] if spec["ring_axis"] == "sp" else m[-1]
    mesh = Mesh(np.asarray(devices[:n]), axis_names=("sp",))
    out = {}
    for logz2 in ("unmasked", "masked"):
        o = jlvlm.lvlm_forward(params, cfg, _jax_batch(spec["batch"]), shift=spec["shift"],
                               logz2=logz2, capture_attn=True, attn_impl="ring", ring_mesh=mesh)
        out[logz2] = (np.asarray(o.logits), np.asarray(o.decoder.attn_capture))
    return out


def _jax_grads(cfg, params, spec):
    """``jax.grad`` of ``compute_loss`` on one device: by (group, leaf)."""
    enc = spec["jax_enc"]
    enc_t = tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))
    kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=tsp.needs_attn_capture(enc_t),
              rec_ffn=tsp.needs_ffn_capture(enc_t), mh=tsp.multi_head(enc_t), **spec["loss_kw"])
    batch = _to_device_batch(SimpleNamespace(**spec["batch"]))
    grads = jax.grad(lambda tr: jax_compute_loss(tr, params, batch, **kw)[0])(spec["trainable"])
    return {(g, n): np.asarray(v) for g, leaves in grads.items() for n, v in leaves.items()}


def _jax_generate(cfg, params, mode, spec, ids):
    """Single-device JAX in ``mode``: greedy tokens, beam-3 tokens and scores,
    and the quantized tree's logits."""
    qp = _quantized(params, mode)
    prefill, decode = (params, qp) if mode == "int8" else (qp, None)
    batch = _jax_batch(spec["batch"])
    greedy = jg.greedy_generate(prefill, cfg, batch, spec["new"], *ids, decode_params=decode)
    beam = jg.beam_generate(prefill, cfg, batch, spec["new"], 3, *ids, decode_params=decode)
    return {"greedy": np.asarray(greedy.tokens), "beam": np.asarray(beam.tokens),
            "beam_scores": np.asarray(beam.scores),
            "logits": np.asarray(jlvlm.lvlm_forward(qp, cfg, batch).logits)}


def _references(jax_side, inputs, steps, devices):
    """Every reference the tests hold the ranks to, each computed once, on a
    few threads (each compiles and runs its own JAX programs)."""
    tasks = {}
    for name, spec in inputs["ring"].items():
        key = spec["model"]
        cfg, params = jax_side[key]
        tasks["ring", name] = (_ring_forward, cfg, params, spec, devices)
        # a model's step case is one batch and tree
        tasks["step", key] = (_jax_step, cfg, params, steps[name])
        tasks["grads", key] = (_jax_grads, cfg, params, steps[name])
    ids = (inputs["eos"], inputs["pad"])
    for spec in inputs["int8"].values():
        key, mode = spec["model"], spec["mode"]
        cfg, params = jax_side[key]
        # both meshes run the same batch
        tasks["generate", (key, mode, spec["batch"]["input_ids"].shape)] = (
            _jax_generate, cfg, params, mode, spec, ids)
    with ThreadPoolExecutor(4) as pool:
        futures = {at: pool.submit(*task) for at, task in tasks.items()}
        refs = {"ring": {}, "step": {}, "grads": {}, "generate": {}}
        for (kind, at), future in futures.items():
            refs[kind][at] = future.result()
    refs["quantized"] = {(key, mode): _quantized(jax_side[key][1], mode)
                         for key in ("idefics2", "qwen") for mode in MODES}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory, eight_devices):
    """The ranks' outputs and the references, computed while the ranks run."""
    tk = SimpleTokenizer(padding_side="left")
    models, jax_side = {}, {}
    for i, key in enumerate(MODELS):
        spec = _spec(key, tk)
        cfg = _cfg(spec)
        params = _params(key, cfg, 30 + i)
        models[key] = (spec, params)
        jax_side[key] = (cfg, params)
    mimic, _ = get_preset("mimic")
    ring, steps = {}, {}
    for name, (key, m, axis) in RING.items():
        cfg = jax_side[key][0]
        shift = jax.tree.map(lambda x: np.asarray(x) * 50.0, init_shift_params(
            mimic, cfg.text, jax.random.PRNGKey(1)))
        steps[name] = _step_case(key, "mimic", cfg, None)
        ring[name] = {"model": key, "mesh": m, "ring_axis": axis, "shift": shift,
                      "batch": _image_batch(cfg, tk),
                      "step": {f: v for f, v in steps[name].items() if f != "jax_enc"}}
    int8 = {name: {"model": key, "mesh": m, "mode": mode, "new": NEW, "beam": True,
                   "batch": _text_batch(4, 16, 5, 0)}
            for name, (key, m, mode) in INT8.items()}
    # a prompt region over QUANT_KV_MIN_PROMPT slots
    int8[LONG] = {"model": "qwen", "mesh": (1, 4), "mode": "int8", "new": 3, "beam": True,
                  "batch": _text_batch(2, QUANT_KV_MIN_PROMPT + 16, 40, 1)}
    prompts = [np.random.default_rng(9).integers(4, 250, size=(n,)).astype(np.int32)
               for n in (6, 11, 17)]
    inputs = {"models": models, "ring": ring, "int8": int8,
              "engine": {"model": "idefics2-kv1", "prompts": prompts},
              "eos": tk.eos_token_id, "pad": tk.pad_token_id}
    ranks = {}

    def run():
        try:
            ranks["outs"] = run_world("torch_workers:model_axis_world", 4,
                                      tmp_path_factory.mktemp("model_axis"), inputs)
        except BaseException as e:  # raised in the test's thread below
            ranks["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = _references(jax_side, inputs, steps, eight_devices)
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return inputs, steps, refs, ranks["outs"]


def _rows(outs, rank, mesh, want):
    """The rows of a batch-sized reference that ``rank`` holds on ``mesh``."""
    if mesh[0] == 1:
        return want
    d = tuple(outs[rank]["coord"][mesh])[0]
    half = want.shape[0] // 2
    return want[d * half:(d + 1) * half]


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------


def test_head_region_reads_the_facts_of_the_call():
    """4 heads on 4 KV heads of 16 at model 4: whole heads, one a rank, unless
    the projections are handles, the ring runs over ``model`` or the cache
    holds every KV head; a cache of another count raises."""
    with parallel.use_mesh(StandIn(4)):
        assert tp.head_region(4, 4, 16) == (1, 1)
        assert tp.head_region(4, 4, 16, ring_axis="sp") == (1, 1)
        assert tp.head_region(4, 4, 16, handles=True) == (4, 4)
        assert tp.head_region(4, 4, 16, ring_axis="model") == (4, 4)
        assert tp.head_region(4, 4, 16, cache_heads=4) == (4, 4)
        assert tp.head_region(4, 4, 16, cache_heads=1) == (1, 1)
        assert tp.head_region(4, 4, 16, handles=True, cache_heads=4) == (4, 4)
        with pytest.raises(ValueError, match="the cache holds 1 KV heads"):
            tp.head_region(4, 4, 16, handles=True, cache_heads=1)
        with pytest.raises(ValueError, match="the cache holds 2 KV heads"):
            tp.head_region(4, 4, 16, cache_heads=2)
        cfg = _cfg(_spec("idefics2-mha", SimpleTokenizer())).text
        assert td.init_kv_cache(cfg, 1, 1, "cpu")["k"].shape[3] == 1
        assert td.init_kv_cache(cfg, 1, 1, "cpu", handles=True)["k"].shape[3] == 4
    assert tp.head_region(4, 4, 16, handles=True, ring_axis="model") == (4, 4)


@pytest.mark.parametrize("total", [7, 9, 12])
def test_make_decode_mask_matches_jax(total):
    mask = np.random.default_rng(total).integers(0, 2, size=(3, 7)).astype(np.int32)
    want = np.asarray(jd.make_decode_mask(jnp.asarray(mask), total))
    got = td.make_decode_mask(torch.from_numpy(mask), total)
    assert got.dtype == torch.bool and got.shape == want.shape == (3, 1, 1, max(total, 7))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the ring with a model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logz2", ["unmasked", "masked"])
@pytest.mark.parametrize("case", list(RING))
def test_ring_forward_matches_jax(world, case, logz2):
    """Every row against JAX's ring: JAX's ring and its plain attention differ
    by up to 2.4e-4 here (the shift's μ-gate, 50x the init, amplifies the
    summation order), the port's ring and JAX's by far less."""
    inputs, _, refs, outs = world
    m = inputs["ring"][case]["mesh"]
    logits, caps = refs["ring"][case][logz2]
    for rank, out in enumerate(outs):
        got = out["ring"][case]
        # both calls' self-attention rode the ring
        assert got["paths"] == ["ring", "ring"]
        got_logits, got_caps = got["forward"][logz2]
        np.testing.assert_allclose(got_logits, _rows(outs, rank, m, logits), rtol=TOL, atol=TOL)
        for layer, c in enumerate(caps):
            np.testing.assert_allclose(got_caps[layer], _rows(outs, rank, m, c), rtol=TOL,
                                       atol=TOL, err_msg=f"layer {layer}")


@pytest.mark.parametrize("case", list(RING))
def test_ring_step_matches_single_device_jax(world, case):
    inputs, steps, refs, outs = world
    state, metrics = refs["step"][inputs["ring"][case]["model"]]
    for out in outs:
        got = out["ring"][case]
        assert got["step_paths"] == ["ring", "ring"]  # the record and the shift pass
        assert set(got["metrics"]) == set(metrics)
        for key, w in metrics.items():
            w = float(np.asarray(w))
            assert abs(got["metrics"][key] - w) <= TOL * abs(w), (key, got["metrics"][key], w)
        for group, leaves in state.trainable.items():
            for name, w in leaves.items():
                w, g = np.asarray(w), got["trainable"][group][name]
                assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), f"{group}.{name}"
                assert not np.array_equal(g, steps[case]["trainable"][group][name])


@pytest.mark.parametrize("case", list(RING))
def test_ring_gradients_match_jax(world, case):
    """Every shift leaf's gradient on every rank equals ``jax.grad``'s within
    1e-5 of its norm: whole on each rank of the ring, summed over ``model``
    by ``copy_to_region`` alone, and over ``data`` as the step sums it."""
    inputs, _, refs, outs = world
    want = refs["grads"][inputs["ring"][case]["model"]]
    for out in outs:
        got = out["ring"][case]["grads"]
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.linalg.norm(w) > 0, path
            assert np.linalg.norm(got[path] - w) <= TOL * np.linalg.norm(w), path


# ---------------------------------------------------------------------------
# int8 handles under model > 1
# ---------------------------------------------------------------------------


def _jax_handles(tree, path=""):
    if isinstance(tree, dict) and "q8" in tree:
        return {path: tree}
    if not isinstance(tree, dict):
        return {}
    return {p: h for k, v in tree.items() for p, h in _jax_handles(v, f"{path}{k}/").items()}


@pytest.mark.parametrize("case", list(INT8))
def test_set_quant_handles_equal_jax(world, case):
    """``set_quant`` under the mesh gives every handle of JAX's
    ``quantize_lm_params`` of the whole tree, bit for bit, on every rank."""
    _, _, refs, outs = world
    key, _, mode = INT8[case]
    want = {p.rstrip("/"): h for p, h in _jax_handles(refs["quantized"][key, mode]).items()}
    assert len(want) == 5  # qkv, o, gateup, down, the lm head
    for out in outs:
        got = {p.rstrip("/"): h for p, h in out["int8"][case]["handles"].items()}
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert sorted(got[path]) == sorted(w), path  # the a8 marker as JAX's
            for part in ("q8", "scale"):
                g, x = got[path][part], np.asarray(w[part])
                assert g.dtype == x.dtype and g.shape == x.shape, (path, part)
                assert np.array_equal(g.view(np.uint8), x.view(np.uint8)), (path, part)


@pytest.mark.parametrize("case", list(INT8) + [LONG])
def test_int8_generate_matches_single_device_jax(world, case):
    inputs, _, refs, outs = world
    spec = inputs["int8"][case]
    m = spec["mesh"]
    want = refs["generate"][spec["model"], spec["mode"], spec["batch"]["input_ids"].shape]
    for rank, out in enumerate(outs):
        got = out["int8"][case]
        for name in ("greedy", "beam"):
            np.testing.assert_array_equal(got[name], _rows(outs, rank, m, want[name]))
        for name in ("beam_scores", "logits"):
            np.testing.assert_allclose(got[name], _rows(outs, rank, m, want[name]),
                                       rtol=TOL, atol=TOL)


def test_serve_engine_with_int8_handles(world):
    """The serve engine on model 4 with the ``"int8"`` runner's trees (its
    prefill on the cut bf16 tree, its decode steps on whole handles) gives
    the one-process engine's tokens, its slot cache holding every KV head."""
    inputs, _, _, outs = world
    case = inputs["engine"]
    spec, params = inputs["models"][case["model"]]
    cfg = _cfg(spec, port_configs.get_model_config)
    whole = to_torch(params, "cpu")
    eng = ServeEngine(cfg, whole, decode_params=tq.quantize_lm_params(whole), num_slots=2,
                      max_len=48, prefill_buckets=(8, 16, 32), decode_block=2, device="cpu")
    for i, p in enumerate(case["prompts"]):
        eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
    with torch.no_grad():
        want = [r.tokens for r in eng.run()]
    assert all(len(t) > 0 for t in want)
    for out in outs:
        assert out["engine"] == want
        assert out["engine_cache_heads"] == cfg.text.num_kv_heads

