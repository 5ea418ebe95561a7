"""The vision-feature caches of mimic_tpu_torch against the JAX package.

``models/feature_cache.py::VisionFeatureCache`` (the runner's eval cache) and
``train/vision_cache.py::TrainVisionCache`` (the train loop's), on a tiny
idefics2 in fp32 with parameters drawn by the JAX initialisers and carried
across by the bridge.  Cached features are held to JAX's within 1e-5; cached
and uncached ``run_eval`` records must be identical, and identical to JAX's;
the train step on cached features is held to the step on pixels and to JAX's
cached step within 1e-5.  The unit cases are those of
``tests/test_feature_cache.py`` and ``tests/test_train_vision_cache.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mimic_tpu.config import DataConfig as JDataConfig
from mimic_tpu.config import EvalConfig as JEvalConfig
from mimic_tpu.config import get_preset as jget_preset
from mimic_tpu.models import feature_cache as jfc
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.models.processor import LVLMProcessor as JProcessor
from mimic_tpu.models.runner import LVLMRunner as JRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer as JTokenizer
from mimic_tpu.pipeline.evaluate import run_eval as jrun_eval
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.train import TrainCollator as JCollator
from mimic_tpu.train import TrainState as JState
from mimic_tpu.train import build_optimizer as jbuild_optimizer
from mimic_tpu.train import make_train_step as jmake_train_step
from mimic_tpu.train.vision_cache import TrainVisionCache as JTrainVisionCache
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.config import DataConfig, EvalConfig, TrainConfig, get_preset
from mimic_tpu_torch.models import feature_cache as tfc
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models.lvlm import encode_images
from mimic_tpu_torch.models.processor import LVLMProcessor
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
from mimic_tpu_torch.pipeline import train_entry as te
from mimic_tpu_torch.pipeline.evaluate import run_eval
from mimic_tpu_torch.train import checkpoints as tck
from mimic_tpu_torch.train import step as ts
from mimic_tpu_torch.train.collate import TrainCollator
from mimic_tpu_torch.train.optim import build_optimizer
from mimic_tpu_torch.train.vision_cache import TrainVisionCache
from mimic_tpu_torch.utils import get_expand_runname

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synthetic_vqa_splits(n_train=4, n_val=6, size=28):
    rng = np.random.default_rng(7)

    def item(i, split):
        return {
            "question": f"what color is object {i}?",
            "question_id": i if split == "train" else 1000 + i,
            "question_type": "what color is", "answer_type": "other",
            "answers": [{"answer": "red", "answer_confidence": "yes", "answer_id": j}
                        for j in range(10)],
            "answer": "red",
            "image": rng.integers(0, 255, size=(size, size, 3)).astype(np.uint8),
            "image_id": i,
        }

    return {"train": [item(i, "train") for i in range(n_train)],
            "validation": [item(i, "val") for i in range(n_val)]}


@pytest.fixture(scope="module")
def tiny():
    """(cfg, JAX numpy params) for tiny idefics2 with the byte tokenizer's ids."""
    tk = JTokenizer()
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    return cfg, jax.tree.map(np.asarray, init_lvlm_params(cfg, jax.random.PRNGKey(0)))


def _runners(tiny):
    cfg, params = tiny
    jr = JRunner(cfg, params, JTokenizer(padding_side="left"), pad_multiple=32)
    tr = LVLMRunner(cfg, to_torch(params, "cpu"), SimpleTokenizer(padding_side="left"),
                    device="cpu", pad_multiple=32)
    return jr, tr


def _eval_cfg(cls=EvalConfig, data_cls=DataConfig, vision_cache=False):
    cfg = cls(model_name="tiny-idefics2", batch_size=2, iterations=2)
    cfg.vision_cache = vision_cache
    cfg.data = data_cls(name="vqav2", num_query_samples=4, num_shot=2, seed=3407)
    cfg.generation.num_beams = 1
    cfg.generation.max_new_tokens = 4
    return cfg


def _pixels(cfg, seed, shape):
    size = cfg.vision.image_size
    return np.random.default_rng(seed).normal(size=shape + (size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# VisionFeatureCache
# ---------------------------------------------------------------------------


def test_cached_features_match_jax_cache(tiny):
    cfg, params = tiny
    px = _pixels(cfg, 0, (2, 3))
    px[1, 2] = px[0, 1]  # one image repeated across rows
    keys = [tfc.image_key(px[b, i]) for b in range(2) for i in range(3)]
    jcache, tcache = jfc.VisionFeatureCache(), tfc.VisionFeatureCache()
    want = np.asarray(jcache.get_features(params, cfg, px, None, keys))
    got = tcache.get_features(to_torch(params, "cpu"), cfg, px, None, keys)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert (tcache.hits, tcache.misses, len(tcache)) == (jcache.hits, jcache.misses, len(jcache))
    assert (tcache.misses, tcache.hits) == (5, 1)  # 6 slots, 5 distinct images
    # the repeated image's two occurrences are the same stored features
    S = got.shape[1] // 3
    assert torch.equal(got[0, S:2 * S], got[1, 2 * S:])
    # against a direct encode of the whole batch, and a second call: all hits,
    # bit-identical to the first assembly
    direct = encode_images(to_torch(params, "cpu"), cfg, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=TOL, atol=TOL)
    again = tcache.get_features(to_torch(params, "cpu"), cfg, px, None, keys)
    assert torch.equal(again, got) and tcache.misses == 5 and tcache.hit_rate == 7 / 12
    assert tcache.nbytes == len(tcache) * S * cfg.text.hidden_size * 4


def test_misses_encode_exactly_their_rows(tiny, monkeypatch):
    """No power-of-two padding: a cold batch of 3 distinct images encodes 3 rows."""
    cfg, params = tiny
    rows = []
    orig = tfc.encode_images

    def spy(p, c, px, pm, attn_impl="xla"):
        rows.append(px.shape[0])
        return orig(p, c, px, pm, attn_impl=attn_impl)

    monkeypatch.setattr(tfc, "encode_images", spy)
    px = _pixels(cfg, 3, (1, 4))
    px[0, 3] = px[0, 0]
    keys = [tfc.image_key(px[0, i]) for i in range(4)]
    cache = tfc.VisionFeatureCache()
    cache.get_features(to_torch(params, "cpu"), cfg, px, None, keys)
    cache.get_features(to_torch(params, "cpu"), cfg, px, None, keys)
    assert rows == [3]  # deduplicated, unpadded, and nothing on the second call


def test_patch_mask_variants_are_distinct_keys(tiny):
    cfg, params = tiny
    px = _pixels(cfg, 1, (1, 1))
    nh = cfg.vision.image_size // cfg.vision.patch_size
    pm_full = np.ones((1, 1, nh, nh), np.int32)
    pm_half = pm_full.copy()
    pm_half[..., nh // 2:] = 0
    cache = tfc.VisionFeatureCache()
    tparams = to_torch(params, "cpu")
    f_full = cache.get_features(tparams, cfg, px, pm_full, [("a",)])
    f_half = cache.get_features(tparams, cfg, px, pm_half, [("b",)])
    assert cache.misses == 2 and not torch.equal(f_full, f_half)
    want = jfc.VisionFeatureCache().get_features(params, cfg, px, pm_half, [("b",)])
    np.testing.assert_allclose(f_half.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("entries", [1, 3])
def test_eviction_bound(tiny, entries):
    cfg, params = tiny
    tparams = to_torch(params, "cpu")
    probe = tfc.VisionFeatureCache()
    probe.get_features(tparams, cfg, _pixels(cfg, 2, (1, 1)), None, [("probe",)])
    entry = probe.nbytes
    assert entry > 0
    cache = tfc.VisionFeatureCache(max_bytes=entries * entry)
    for i in range(8):
        cache.get_features(tparams, cfg, _pixels(cfg, 10 + i, (1, 1)), None, [(i,)])
    assert len(cache) == entries and cache.nbytes == entries * entry
    # the most recent entries survive (LRU)
    assert list(cache._store) == [(i,) for i in range(8 - entries, 8)]


def test_tight_budget_hits_survive_assembly(tiny):
    """A budget smaller than one batch must not evict a same-batch hit between
    the misses' insert and the assembly."""
    cfg, params = tiny
    tparams = to_torch(params, "cpu")
    imgs = list(_pixels(cfg, 5, (4,)))
    probe = tfc.VisionFeatureCache()
    probe.get_features(tparams, cfg, imgs[0][None, None], None, [tfc.image_key(imgs[0])])
    entry = probe.nbytes
    cache = tfc.VisionFeatureCache(max_bytes=2 * entry)  # below one 3-slot batch
    cache.get_features(tparams, cfg, imgs[0][None, None], None, [tfc.image_key(imgs[0])])
    px = np.stack([imgs[0], imgs[1], imgs[2]])[None]  # 1 hit + 2 misses
    keys = [tfc.image_key(imgs[i]) for i in (0, 1, 2)]
    got = cache.get_features(tparams, cfg, px, None, keys)
    want = jfc.encode_images(params, cfg, px, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert cache.nbytes <= 2 * entry  # the budget holds after assembly


@pytest.mark.parametrize("make", [lambda cfg, p: tfc.VisionFeatureCache().get_features(
    p, cfg, np.zeros((1, 1, 28, 28, 3), np.float32), None, [("x",)]),
    lambda cfg, p: TrainVisionCache(cfg, p)], ids=["feature_cache", "train_cache"])
def test_idefics1_rejected(make):
    cfg = get_model_config("tiny-idefics1")
    with pytest.raises(ValueError):
        make(cfg, {})


@pytest.mark.parametrize("kind", ["uint8", "float32", "none", "pil", "processed-slot"])
def test_image_key_matches_jax(kind):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 255, size=(6, 5, 3)).astype(np.uint8)
    if kind == "none":
        img, other = None, a
    elif kind == "pil":
        Image = pytest.importorskip("PIL.Image")
        img, other = Image.fromarray(a), Image.fromarray(255 - a)
    elif kind == "processed-slot":
        px = rng.normal(size=(2, 3, 6, 6, 3)).astype(np.float32)
        img, other = px[1, 2], px[0, 1]
    else:
        img = a.astype(kind)
        other = (a + 1).astype(kind)
    assert tfc.image_key(img) == jfc.image_key(img)
    assert tfc.image_key(img) == tfc.image_key(img) and tfc.image_key(img) != tfc.image_key(other)


# ---------------------------------------------------------------------------
# the runner's cache and the eval entry
# ---------------------------------------------------------------------------


def test_records_identical_with_and_without_cache_and_to_jax(tiny, tmp_path):
    """4 support items x (2 shots x 4 queries) draws: demo images repeat."""
    splits = synthetic_vqa_splits()
    jr, tr = _runners(tiny)
    base_records, base_metrics = run_eval(_eval_cfg(), tr, result_dir=str(tmp_path / "a"),
                                          splits=splits)
    assert tr.vision_cache is None  # vision_cache=False builds none
    cache = tr.enable_vision_cache()
    records, metrics = run_eval(_eval_cfg(), tr, result_dir=str(tmp_path / "b"), splits=splits)
    assert records == base_records and metrics == base_metrics
    assert cache.hits > 0 and cache.misses > 0 and len(cache) <= cache.misses
    jrecords, jmetrics = jrun_eval(_eval_cfg(JEvalConfig, JDataConfig, vision_cache=True), jr,
                                   result_dir=str(tmp_path / "j"), splits=splits)
    assert records == jrecords and metrics == jmetrics
    assert (cache.hits, cache.misses) == (jr.vision_cache.hits, jr.vision_cache.misses)


@pytest.mark.parametrize("flag", [True, False], ids=["on", "off"])
def test_run_eval_cache_flag(tiny, tmp_path, flag):
    """``EvalConfig.vision_cache`` is on by default, as in the JAX package:
    ``run_eval`` turns the runner's cache on; off, it builds none."""
    assert EvalConfig().vision_cache
    _, tr = _runners(tiny)
    assert tr.vision_cache is None
    run_eval(_eval_cfg(vision_cache=flag), tr, result_dir=str(tmp_path),
             splits=synthetic_vqa_splits())
    if not flag:
        assert tr.vision_cache is None
        return
    assert tr.vision_cache is not None and tr.vision_cache.misses > 0
    assert tr.vision_cache.max_bytes == EvalConfig().vision_cache_mb * 1024 * 1024


def test_second_eval_only_hits(tiny, tmp_path):
    splits = synthetic_vqa_splits()
    _, tr = _runners(tiny)
    cache = tr.enable_vision_cache()
    run_eval(_eval_cfg(), tr, result_dir=str(tmp_path / "a"), splits=splits)
    m0, h0 = cache.misses, cache.hits
    run_eval(_eval_cfg(), tr, result_dir=str(tmp_path / "b"), splits=splits)
    assert cache.misses == m0 and cache.hits > h0


def test_hits_send_no_pixels_and_skip_the_tower(tiny, monkeypatch):
    _, tr = _runners(tiny)
    tr.enable_vision_cache()
    images = [[np.random.default_rng(i).integers(0, 255, (28, 28, 3)).astype(np.uint8)]
              for i in range(2)]
    texts = ["Image:<image> Question: what? Answer:", "Image:<image> Question: who? Answer:"]
    cold = tr.generate(images, texts, max_new_tokens=3)
    seen, encodes = [], []
    orig_prefill, orig_encode = tg._prefill, tfc.encode_images

    def prefill(params, cfg_, batch, *a, **k):
        seen.append(batch.pixel_values)
        return orig_prefill(params, cfg_, batch, *a, **k)

    monkeypatch.setattr(tg, "_prefill", prefill)
    monkeypatch.setattr(tfc, "encode_images", lambda *a, **k: encodes.append(1) or orig_encode(*a, **k))
    warm = tr.generate(images, texts, max_new_tokens=3)
    assert warm == cold and seen == [None] and not encodes
    assert tr.vision_cache.hits == 2 and tr.vision_cache.misses == 2
    tr.vision_cache = None
    assert tr.generate(images, texts, max_new_tokens=3) == cold


def test_runner_cache_keys_match_jax(tiny):
    cfg, _ = tiny
    jr, tr = _runners(tiny)
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 255, (28, 28, 3)).astype(np.uint8) for _ in range(2))
    texts = ["Image:<image> x", "Image:<image>Image:<image> y"]
    for images in ([[a], [a, b]], a):
        t = texts if isinstance(images, list) else texts[0]
        enc = tr.processor(images, t)
        assert tr._image_cache_keys(images, enc) == jr._image_cache_keys(images, enc)


@pytest.mark.parametrize("mode", [None, "int8", "int8-memory"])
def test_set_quant_clears_the_cache(tiny, mode):
    _, tr = _runners(tiny)
    cache = tr.enable_vision_cache()
    cache._store[("x",)] = torch.zeros(4, 64)
    cache._bytes = 1024
    tr.set_quant(mode)
    assert len(cache) == 0 and cache.nbytes == 0 and tr.vision_cache is cache


# ---------------------------------------------------------------------------
# the training cache
# ---------------------------------------------------------------------------


def _string_batch(pool, draw_seed):
    rng = np.random.default_rng(draw_seed)
    pick = lambda: pool[rng.integers(len(pool))]  # noqa: E731
    return {
        "prefix_texts": ["Image:<image> Question: what is this? Answer: a cat\n",
                         "Image:<image> Question: how many? Answer: two\n"],
        "query_texts": ["Image:<image> Question: what now? Answer:",
                        "Image:<image> Question: who? Answer:"],
        "answers": ["a dog", "three"],
        "images": [[pick(), pick()], [pick(), pick()]],
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def test_train_cache_step_matches_pixel_step_and_jax(tiny):
    cfg, params = tiny
    enc, peft = get_preset("mimic")
    jshift = jax.tree.map(np.asarray, init_shift_params(jget_preset("mimic")[0], cfg.text,
                                                        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(3)]
    collator = TrainCollator(LVLMProcessor(cfg, SimpleTokenizer(padding_side="right")),
                             enc.strategy(), num_image_in_query=1, emit_image_keys=True)
    tb = collator(_string_batch(pool, 0))
    assert tb.full_image_keys is not None and tb.query_image_keys is not None

    def run(batch_fn, n=2):
        trainable = {"shift": to_torch(jshift, "cpu")}
        tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip=1.0)
        step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                                  align_loss_weight=peft.align_loss_weight)
        state = ts.TrainState(trainable, tx.init(trainable), 0)
        rows = []
        for _ in range(n):
            state, m = step(state, to_torch(params, "cpu"), batch_fn())
            rows.append({k: float(v) for k, v in m.items()})
        return state, rows

    xform = TrainVisionCache(cfg, to_torch(params, "cpu"))
    assert xform.attn_impl == "xla"  # the CPU's default
    cached = xform(tb)
    assert {"full_feats", "query_feats"} <= set(cached) and not any("pixel" in k or "patch" in k
                                                                     for k in cached)
    s_px, m_px = run(lambda: ts.to_device_batch(tb, "cpu"))
    s_ft, m_ft = run(lambda: xform(tb))
    for a, b in zip(m_px, m_ft):
        for k in a:
            assert abs(a[k] - b[k]) <= TOL * max(abs(a[k]), 1.0), (k, a[k], b[k])
    for k, v in _flat(s_px.trainable).items():
        np.testing.assert_allclose(_flat(s_ft.trainable)[k], v, rtol=TOL, atol=TOL)

    # JAX's cached step on the same batch, from the same shift
    jenc, jpeft = jget_preset("mimic")
    jtrain = {"shift": jshift}
    jtx = jbuild_optimizer(jtrain, lr=jpeft.lr, weight_decay=1e-3, warmup_steps=1,
                           total_steps=10, grad_clip=1.0)
    jstep = jmake_train_step(cfg, jenc, jtx, ce_loss_weight=jpeft.ce_loss_weight,
                             align_loss_weight=jpeft.align_loss_weight, donate=False)
    jcollator = JCollator(JProcessor(cfg, JTokenizer(padding_side="right")), jenc.strategy(),
                          num_image_in_query=1, emit_image_keys=True)
    jxform = JTrainVisionCache(cfg, params)
    jstate = JState(jtrain, jtx.init(jtrain), np.zeros((), np.int32))
    jtb = jcollator(_string_batch(pool, 0))
    for _ in range(2):
        jstate, _ = jstep(jstate, params, jxform(jtb))
    for k, v in _flat(jax.tree.map(np.asarray, jstate.trainable)).items():
        np.testing.assert_allclose(_flat(s_ft.trainable)[k], v, rtol=TOL, atol=TOL)

    # a second draw from the same pool: every image is a hit
    m0 = xform.cache.misses
    xform(collator(_string_batch(pool, 1)))
    assert xform.cache.misses == m0 and xform.cache.hits > 0


def test_train_cache_leaves_uncached_passes_alone(tiny):
    """A pass without keys (the collator emits none) keeps its pixels."""
    cfg, params = tiny
    rng = np.random.default_rng(3)
    pool = [rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(3)]
    collator = TrainCollator(LVLMProcessor(cfg, SimpleTokenizer(padding_side="right")),
                             get_preset("mimic")[0].strategy(), emit_image_keys=True)
    tb = dataclasses.replace(collator(_string_batch(pool, 0)), query_image_keys=None)
    batch = TrainVisionCache(cfg, to_torch(params, "cpu"))(tb)
    assert "full_feats" in batch and "full_pixels" not in batch
    assert "query_feats" not in batch
    assert torch.equal(batch["query_pixels"], torch.from_numpy(tb.query_pixels))


def test_train_loop_uses_the_batch_transform(tmp_path):
    from mimic_tpu_torch.train import trainer as ttrainer

    seen = []
    cfg = _train_cfg(True)
    cfg.epochs = 2
    state = ts.TrainState({"shift": {"w": torch.zeros(2)}}, None, 0)

    def step(state, frozen, batch):
        seen.append(batch)
        return state._replace(step=state.step + 1), {"loss": torch.tensor(0.0)}

    ttrainer.train_loop(cfg, state, {}, step, lambda epoch: ["a", "b"],
                        result_dir=str(tmp_path), batch_transform=lambda b: {"from": b})
    assert seen == [{"from": "a"}, {"from": "b"}] * 2


def _train_cfg(vision_cache):
    enc, peft = get_preset("mimic")
    cfg = TrainConfig(runname="vcache", model_name="tiny-idefics2", encoder=enc, peft=peft,
                      epochs=2, batch_size=2, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 4, 1
    cfg.vision_cache = vision_cache
    return cfg


def test_run_train_cached_and_uncached_checkpoints_agree(tiny, tmp_path, monkeypatch):
    """``run_train`` with the cache (the default, as in the JAX package) and
    without it writes the same checkpoint within 1e-5; after the first epoch
    every train image is a hit."""
    made, misses = [], []

    class Spy(TrainVisionCache):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def __call__(self, tb):
            out = super().__call__(tb)
            misses.append(self.cache.misses)
            return out

    monkeypatch.setattr(te, "TrainVisionCache", Spy)
    assert TrainConfig().vision_cache
    trees = {}
    for on in (True, False):
        _, tr = _runners(tiny)
        cfg = _train_cfg(on)
        te.run_train(cfg, result_dir=str(tmp_path / str(on)), runner=tr,
                     splits=synthetic_vqa_splits(n_train=6, n_val=2))
        ckpt = tmp_path / str(on) / "ckpt" / get_expand_runname(cfg) / "epoch-1"
        trees[on] = _flat(tck.load_trainable(str(ckpt)))
    assert len(made) == 1  # vision_cache=False builds none
    # 2 epochs of the same steps: no miss after the first epoch's batches
    per_epoch = len(misses) // 2
    assert len(misses) == 2 * per_epoch and misses[per_epoch - 1] > 0
    assert misses[per_epoch - 1:] == [misses[per_epoch - 1]] * (per_epoch + 1)
    assert made[0].cache.hits > 0
    for k, v in trees[False].items():
        np.testing.assert_allclose(trees[True][k], v, rtol=TOL, atol=TOL)
