"""Tensor parallelism whose ``model`` axis cuts inside an attention head,
against the JAX package, where GSPMD runs the same ``shard_params`` layouts.

Without processes: ``tp.whole_heads`` / ``tp.head_region`` on every config
of ``MODEL_CONFIGS`` at ``model`` 2, 4 and 8 (never raising; a whole-heads
rank's query heads read exactly its own KV heads); at 8 the projections cut
inside a head are exactly idefics2-8b-base's connector k/v, and
llava-interleave-7b's and qwen2-7b's decoder q/k/v, and only their
attentions run gathered (the connector's q, two whole heads a rank, is
gathered with its k/v, since a gathered region attends over every head).
This is the port's counterpart of ``tests/test_real_scale_compile.py``'s
8-way claim.  A connector MLP's local width the axis does not divide is read
against the config's width: whole runs replicated, split runs split.

One module-scoped world of four ``gloo`` processes, as a (data 1 x model 4)
and a (data 2 x model 2) mesh, each rank with a copy of its ``shard_params``
tree (the eval's runner a cast of it), as a move to the card makes one, and
its ``shard_batch`` rows, in fp32:

- tiny-idefics2 at model 4, whose text KV (2 x 16), ViT (2 x 16) and
  connector (2 x 32) all split inside a head: ``lvlm_forward`` with images
  and the MimIC shift (multi-head and flat) within 2e-4 of single-device JAX;
  greedy and beam-3 tokens identical to JAX's on
  ``tests/test_sharded_generate.py``'s tree and batch, beam scores within
  1e-5, the cache holding every KV head; one ``mimic``, one flat-shift and
  one prefix-tuning step (the prefix's slots hold every KV head), metrics
  and updated trainables within 1e-5 (``TOL`` of
  ``tests/test_torch_train_mesh.py``).
- **The gradient trap.** ``compute_loss``'s shift-leaf gradients of those
  steps at model 4 against ``jax.grad`` within 1e-5 of each leaf's norm.  The
  gathered attention's output reaches ``o_proj``'s rows through
  ``tp.scatter_to_region``, whose backward gathers the rows' gradients; with
  a plain ``narrow`` there each rank's q/k/v and shift gradients would be only
  its own rows' share, and these gradients (and the steps' ``grad_norm``)
  would fail.
- A Qwen2-shaped tiny llava-interleave tower (7 query heads on 1 KV head of
  16, q/k/v biases) at model 2 and model 4: logits with images, greedy
  tokens and one LoRA step (dropout 0, so JAX draws no mask) against JAX, its
  gradients at model 4.
- tiny-idefics1 at model 4 (ViT and resampler gathered, the cross layers on
  whole heads) and with two text heads (self and cross layers gathered too):
  logits with images within 2e-4.
- A tiny idefics2 whose connector MLP width (130) model 4 does not divide,
  run replicated, and one whose width (520) it splits to 130, which it does
  not divide either: JAX's logits.
- The serve engine on tiny-text at model 4 gives the unsharded engine's
  tokens, its cache holding both KV heads.

Ring attention and int8 handles under a model axis are held in
``tests/test_torch_model_axis.py``.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import LoraConfig, PrefixConfig, config_to_dict, get_preset
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.shift.lora import init_lora_params
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.shift.prefix import init_prefix_params
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu.train.step import compute_loss as jax_compute_loss
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch import parallel
from mimic_tpu_torch.bridge import to_torch, tree_map
from mimic_tpu_torch.models import config as port_configs
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import vision as tv
from mimic_tpu_torch.parallel import tp
from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest
from mimic_tpu_torch.shift import params as tsp
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.models.tokenizer import SimpleTokenizer as PortTokenizer
from mimic_tpu_torch.pipeline.train_entry import run_train
from test_eval_e2e import synthetic_vqa_splits
from test_torch_train_mesh import FLAT, _string_batch, _train_cfg
from torch_dist import run_world

TOL_LOGITS = 2e-4
TOL = 1e-5

# (model name, text fields beside the tokenizer's vocab[, perceiver fields])
MODELS = {
    "idefics2": ("tiny-idefics2", {}),
    "idefics2-gen": ("tiny-idefics2", {}),
    "qwen": ("tiny-llava-interleave", {"num_heads": 7, "num_kv_heads": 1, "hidden_size": 112}),
    "idefics1": ("tiny-idefics1", {}),
    "idefics1-h2": ("tiny-idefics1", {"num_heads": 2, "num_kv_heads": 2}),
    # connector MLP widths model 4 leaves whole (130), and splits to 130 (520)
    "idefics2-a4": ("tiny-idefics2", {}, {"intermediate_size": 130}),
    "idefics2-a4-split": ("tiny-idefics2", {}, {"intermediate_size": 520}),
    "text": ("tiny-text", {}),
}
FIELDS = {"idefics2": ("input_ids", "attention_mask", "pixel_values", "patch_mask"),
          "idefics1": ("input_ids", "attention_mask", "pixel_values", "pixel_mask",
                       "image_attention_mask"),
          "llava-interleave": ("input_ids", "attention_mask", "pixel_values")}
LORA = LoraConfig(r=4, alpha=8, dropout=0.0)


class StandIn:
    """A ``model`` axis of n ranks without a process group, at rank 0: what
    ``tp``'s widths read of a mesh (its group a stand-in no collective
    reaches)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n):
        self.mesh = torch.zeros(1, n)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return object()


# ---------------------------------------------------------------------------
# the head region of every shipped config, without processes
# ---------------------------------------------------------------------------


def _attentions(cfg):
    """{attention: (query heads, KV heads, head dim)} of a config, as its
    modules compute them."""
    t = cfg.text
    out = {"decoder": (t.num_heads, t.num_kv_heads, t.head_size)}
    if t.cross_attn_interval:
        out["cross"] = out["decoder"]
    if cfg.vision is not None:
        v = cfg.vision
        out["vit"] = (v.num_heads, v.num_heads, v.hidden_size // v.num_heads)
    p = cfg.perceiver
    if p is not None:
        width = v.hidden_size if p.style == "idefics1" else t.hidden_size
        name = "resampler" if p.style == "idefics1" else "connector"
        out[name] = (p.num_heads, p.num_kv_heads or p.num_heads,
                     p.head_dim or width // p.num_heads)
    return out


def _cut_inside(heads, head_dim, n):
    """Whether the rules cut a projection of ``heads`` heads inside a head."""
    return (heads * head_dim) % n == 0 and heads % n != 0


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(port_configs.MODEL_CONFIGS))
def test_head_region_of_every_config(name, n):
    cfg = port_configs.get_model_config(name)
    with parallel.use_mesh(StandIn(n)):
        for what, (H, Hkv, Dh) in _attentions(cfg).items():
            whole = tp.whole_heads(H, Hkv, Dh, n)
            Hr, Hkvr = tp.head_region(H, Hkv, Dh)
            if whole:
                # a rank's query heads read exactly its own KV heads
                assert Hr * Hkv == Hkvr * H and Hr in (H, H // n), (what, Hr, Hkvr)
            else:
                assert (Hr, Hkvr) == (H, Hkv), what
                assert _cut_inside(H, Dh, n) or _cut_inside(Hkv, Dh, n) or Hkv % n
        cache = td.init_kv_cache(cfg.text, 1, 1, "cpu")["k"]
        assert cache.shape[3] == tp.head_region(*_attentions(cfg)["decoder"])[1]


def test_head_split_at_eight_ranks():
    """The projections model 8 cuts inside a head, and the attentions that run
    gathered, are exactly these: the connector's k/v of
    idefics2-8b-base (4 x 96: 48 columns a rank), the decoder's q (28 x 128:
    3.5 heads) and k/v (4 x 128: half a head) of llava-interleave-7b and
    qwen2-7b; nothing of mistral-7b, idefics-9b, llava-1.5-7b, or idefics2's
    decoder and ViT."""
    cut, gathered = set(), set()
    for name in port_configs.MODEL_CONFIGS:
        for what, (H, Hkv, Dh) in _attentions(port_configs.get_model_config(name)).items():
            for proj, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
                if _cut_inside(heads, Dh, 8):
                    cut.add((name, what, proj))
            if not tp.whole_heads(H, Hkv, Dh, 8):
                gathered.add((name, what))
    assert cut == {("idefics2-8b-base", "connector", "k_proj"),
                   ("idefics2-8b-base", "connector", "v_proj"),
                   *((m, "decoder", p) for m in ("llava-interleave-7b", "qwen2-7b")
                     for p in ("q_proj", "k_proj", "v_proj"))}
    assert gathered == {(m, w) for m, w, _ in cut}


@pytest.mark.parametrize("copy", ["as cut", "cloned", "cast"])
def test_connector_width_from_the_config(copy):
    """A connector MLP's local width that model 4 divides is split, whatever
    width the config states (a checkpoint's width of its own: 1024 cut to
    256); one it does not divide is read against the config's width: 130 of
    130 runs replicated, 130 of 520 split, and 130 of 256 raises.  The answer
    reads shapes only, so a clone or a cast of ``shard_params``' tree, as a
    move to the card makes, gets the same."""
    tree = {"modality_proj": {"gate": torch.zeros(8, 130)},
            "layers": {"gate_proj": torch.zeros(2, 8, 520), "up_proj": torch.zeros(2, 8, 1024)}}
    mesh = StandIn(4)
    cut = parallel.shard_params(tree, mesh)
    cut = {"as cut": cut, "cloned": tree_map(lambda t: t.clone(), cut),
           "cast": tree_map(lambda t: t.to(torch.bfloat16), cut)}[copy]
    whole, split = cut["modality_proj"]["gate"], cut["layers"]["gate_proj"]
    assert whole.shape[-1] == split.shape[-1] == 130
    with parallel.use_mesh(mesh):
        assert not tv._connector_split(whole, 130, "gate")
        assert tv._connector_split(split, 520, "gate_proj")
        assert tv._connector_split(cut["layers"]["up_proj"], 256, "up_proj")
        with pytest.raises(ValueError, match="shard_params"):
            tv._connector_split(split, 256, "gate_proj")


def test_region_widths_raise_on_another_width():
    """``gather_from_region`` and ``scatter_to_region`` pass a tensor that holds
    the region's width, act on this rank's share of it (or n times it), and
    raise on any other width, where the shape alone would let it through."""
    with parallel.use_mesh(StandIn(4)):
        x = torch.zeros(2, 12)
        assert tp.gather_from_region(x, 12) is x
        assert tp.scatter_to_region(x, 12) is x
        with pytest.raises(ValueError, match="gather_from_region: 12 columns"):
            tp.gather_from_region(x, 24)
        with pytest.raises(ValueError, match="scatter_to_region: 12 columns"):
            tp.scatter_to_region(x, 6)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _spec(key, tk):
    name, text, *perceiver = MODELS[key]
    top = dict(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
               bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return (name, top, {"vocab_size": tk.vocab_size, **text}, *perceiver)


def _cfg(spec, get=get_model_config):
    name, top, text, *perceiver = spec
    cfg = get(name).replace(**top)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, **text))
    if perceiver:
        cfg = cfg.replace(perceiver=dataclasses.replace(cfg.perceiver, **perceiver[0]))
    return cfg


def _params(key, cfg, seed):
    """JAX's initialisers.  Beside the generation tree of
    ``tests/test_sharded_generate.py`` (key ``idefics2-gen``), every bias and
    layer-norm offset is drawn away from zero (a bias of a gathered projection
    is added on this rank's columns) and idefics1's gates opened."""
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(seed)))
    if key == "idefics2-gen":
        return params
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("bias']") or name.endswith("_b']") or "alpha" in name:
            return (0.3 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


def _images(n):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(n)]


def _image_batch(cfg, tk):
    texts = [f"Image:<image> what is shown in picture {i}? Answer:" for i in range(4)]
    enc = LVLMProcessor(cfg, tk)(_images(4), texts)
    return {k: np.asarray(enc[k]) for k in FIELDS[cfg.family] if enc.get(k) is not None}


def _step_case(key, kind, cfg, model_axis):
    """A train step of ``kind`` (mimic, flat, lora or prefix) on the collator's
    batch of four rows, as ``tests/test_torch_train_mesh.py`` builds it."""
    tk = SimpleTokenizer(padding_side="right")
    jkey = jax.random.PRNGKey(1)
    if kind == "lora":
        enc, peft = get_preset("lora")
        peft.lora = LORA
        tree = {"lora": jax.tree.map(np.asarray, init_lora_params(LORA, cfg.text, jkey))}
        rng = np.random.default_rng(5)
        for name in tree["lora"]:
            if name.endswith("_b"):  # B away from zero, so that A's path carries gradient
                tree["lora"][name] = 0.05 * rng.normal(size=tree["lora"][name].shape)
    elif kind == "prefix":
        enc, peft = get_preset("prefix-tuning")
        tree = {"prefix": init_prefix_params(PrefixConfig(num_virtual_tokens=4), cfg.text, jkey)}
    else:
        enc, peft = get_preset("mimic")
        enc = FLAT if kind == "flat" else enc
        tree = {"shift": init_shift_params(enc, cfg.text, jkey)}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    tb = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1)(
        _string_batch())
    scaling = peft.lora.scaling() if peft.lora else 1.0
    loss_kw = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   lora_scaling=scaling, logz2="unmasked")
    return {
        "model": key, "model_axis": model_axis, "trainable": tree,
        "enc": tconfig.config_to_dict(enc), "jax_enc": enc, "loss_kw": loss_kw,
        "batch": {k: v for k, v in vars(tb).items()
                  if v is not None and not k.endswith("_image_keys")},
        "common": dict(ce_loss_weight=peft.ce_loss_weight,
                       align_loss_weight=peft.align_loss_weight, lora_scaling=scaling,
                       lora_dropout=0.0, seed=3),
        "opt": dict(lr=peft.lr, weight_decay=1e-3, warmup_steps=0, total_steps=10,
                    grad_clip=1.0, scale_lr=peft.scale_lr),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tk = SimpleTokenizer(padding_side="left")
    models, jax_side = {}, {}
    for i, key in enumerate(MODELS):
        spec = _spec(key, tk)
        cfg = _cfg(spec)
        params = _params(key, cfg, 0 if key == "idefics2-gen" else 10 + i)
        models[key] = (spec, params)
        jax_side[key] = (cfg, params)
    mimic, _ = get_preset("mimic")
    cfg2 = jax_side["idefics2"][0]
    shifts = {mh: jax.tree.map(lambda x: np.asarray(x) * 50.0, init_shift_params(
        enc, cfg2.text, jax.random.PRNGKey(1))) for mh, enc in ((True, mimic), (False, FLAT))}
    img = {key: _image_batch(jax_side[key][0], tk)
           for key in ("idefics2", "qwen", "idefics1", "idefics1-h2", "idefics2-a4",
                       "idefics2-a4-split")}
    forward = {
        "idefics2-shift": ("idefics2", 4, shifts[True], True),
        "idefics2-flat-shift": ("idefics2", 4, shifts[False], False),
        "qwen-m2": ("qwen", 2, None, True),
        "qwen-m4": ("qwen", 4, None, True),
        "idefics1": ("idefics1", 4, None, True),
        "idefics1-h2": ("idefics1-h2", 4, None, True),
        "idefics2-a4": ("idefics2-a4", 4, None, True),
        "idefics2-a4-split": ("idefics2-a4-split", 4, None, True),
    }
    forward = {name: {"model": key, "model_axis": m, "batch": img[key], "shift": shift,
                      "multi_head": mh} for name, (key, m, shift, mh) in forward.items()}
    rng = np.random.default_rng(0)
    text = {"input_ids": rng.integers(3, 250, size=(4, 16)).astype(np.int32),
            "attention_mask": np.ones((4, 16), np.int32)}
    text["attention_mask"][1, :5] = 0  # a left-padded row
    generate = {
        "idefics2": {"model": "idefics2-gen", "model_axis": 4, "batch": text, "beam": True},
        "qwen-m2": {"model": "qwen", "model_axis": 2, "batch": text, "beam": False},
        "qwen-m4": {"model": "qwen", "model_axis": 4, "batch": text, "beam": False},
    }
    steps = {
        "idefics2-mimic": _step_case("idefics2-gen", "mimic", jax_side["idefics2-gen"][0], 4),
        "idefics2-flat": _step_case("idefics2-gen", "flat", jax_side["idefics2-gen"][0], 4),
        "idefics2-prefix": _step_case("idefics2-gen", "prefix", jax_side["idefics2-gen"][0], 4),
        "qwen-lora-m2": _step_case("qwen", "lora", jax_side["qwen"][0], 2),
        "qwen-lora-m4": _step_case("qwen", "lora", jax_side["qwen"][0], 4),
    }
    prompts = [np.random.default_rng(9).integers(4, 250, size=(n,)).astype(np.int32)
               for n in (6, 11, 17)]
    train_cfg = _train_cfg()
    train_cfg.mesh.data_axis, train_cfg.mesh.model_axis = 1, 4
    inputs = {
        "models": models, "forward": forward, "generate": generate,
        "steps": {k: {f: v for f, v in s.items() if f != "jax_enc"} for k, s in steps.items()},
        "engine": {"model": "text", "prompts": prompts},
        "run": {"model": "idefics2-gen", "cfg": tconfig.config_to_dict(train_cfg),
                "splits": synthetic_vqa_splits(n_train=16)},
        "eval": {"model": "idefics2", "images": _images(4),
                 "texts": [f"Image:<image> what is shown in picture {i}? Answer:"
                           for i in range(4)]},
        "eos": tk.eos_token_id, "pad": tk.pad_token_id,
    }
    outs = run_world("torch_workers:head_split_world", 4, tmp_path_factory.mktemp("head_split"),
                     inputs)
    return jax_side, inputs, steps, outs


def _rows(outs, rank, model_axis, want):
    """The rows of a batch-sized reference that ``rank`` holds on its mesh."""
    if model_axis == 4:
        return want
    d = tuple(outs[rank]["coord"][2])[0]
    half = want.shape[0] // 2
    return want[d * half:(d + 1) * half]


def _jax_batch(batch):
    return jlvlm.LVLMBatch(**{k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("case", ["idefics2-shift", "idefics2-flat-shift", "qwen-m2", "qwen-m4",
                                  "idefics1", "idefics1-h2", "idefics2-a4",
                                  "idefics2-a4-split"])
def test_forward_matches_single_device_jax(world, case):
    jax_side, inputs, _, outs = world
    spec = inputs["forward"][case]
    cfg, params = jax_side[spec["model"]]
    want = np.asarray(jlvlm.lvlm_forward(params, cfg, _jax_batch(spec["batch"]),
                                         shift=spec["shift"],
                                         multi_head=spec["multi_head"]).logits)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["logits"][case], _rows(outs, rank, spec["model_axis"], want),
                                   rtol=TOL_LOGITS, atol=TOL_LOGITS)


@pytest.mark.parametrize("case", ["idefics2", "qwen-m2", "qwen-m4"])
def test_generate_matches_single_device_jax(world, case):
    jax_side, inputs, _, outs = world
    spec = inputs["generate"][case]
    cfg, params = jax_side[spec["model"]]
    ids = (inputs["eos"], inputs["pad"])
    batch = _jax_batch(spec["batch"])
    greedy = np.asarray(jg.greedy_generate(params, cfg, batch, 4, *ids).tokens)
    beam = jg.beam_generate(params, cfg, batch, 4, 3, *ids) if spec["beam"] else None
    for rank, out in enumerate(outs):
        got, m = out["generate"][case], spec["model_axis"]
        np.testing.assert_array_equal(got["greedy"], _rows(outs, rank, m, greedy))
        # a gathered region's cache holds every KV head on every rank
        assert got["cache_heads"] == cfg.text.num_kv_heads
        if beam is not None:
            np.testing.assert_array_equal(got["beam"], np.asarray(beam.tokens))
            np.testing.assert_allclose(got["beam_scores"], np.asarray(beam.scores),
                                       rtol=1e-5, atol=1e-5)


def _jax_step(cfg, params, case):
    tree = case["trainable"]
    tx = build_optimizer(tree, **case["opt"])
    step = make_train_step(cfg, case["jax_enc"], tx, donate=False, **case["common"])
    state = TrainState(tree, tx.init(tree), jnp.zeros((), jnp.int32))
    return step(state, params, _to_device_batch(SimpleNamespace(**case["batch"])))


@pytest.mark.parametrize("case", ["idefics2-mimic", "idefics2-flat", "idefics2-prefix",
                                  "qwen-lora-m2", "qwen-lora-m4"])
def test_step_matches_single_device_jax(world, case):
    jax_side, _, steps, outs = world
    spec = steps[case]
    cfg, params = jax_side[spec["model"]]
    state, metrics = _jax_step(cfg, params, spec)
    for out in outs:
        got = out["steps"][case]
        assert set(got["metrics"]) == set(metrics)
        for key, w in metrics.items():
            w = float(np.asarray(w))
            assert abs(got["metrics"][key] - w) <= TOL * abs(w), (key, got["metrics"][key], w)
        for group, leaves in state.trainable.items():
            for name, w in leaves.items():
                w, g = np.asarray(w), got["trainable"][group][name]
                assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), f"{group}.{name}"
                assert not np.array_equal(g, spec["trainable"][group][name])


@pytest.mark.parametrize("case", ["idefics2-mimic", "idefics2-flat", "idefics2-prefix",
                                  "qwen-lora-m4"])
def test_gathered_region_gradients_match_jax(world, case):
    """The gradient trap (module docstring): each leaf's gradient on every rank
    of the model-4 mesh equals ``jax.grad``'s within 1e-5 of its norm."""
    jax_side, _, steps, outs = world
    spec = steps[case]
    cfg, params = jax_side[spec["model"]]
    enc = spec["jax_enc"]
    enc_t = tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))
    kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=tsp.needs_attn_capture(enc_t),
              rec_ffn=tsp.needs_ffn_capture(enc_t), mh=tsp.multi_head(enc_t), **spec["loss_kw"])
    batch = _to_device_batch(SimpleNamespace(**spec["batch"]))
    grads = jax.grad(lambda tr: jax_compute_loss(tr, params, batch, **kw)[0])(spec["trainable"])
    want = {(g, n): np.asarray(v) for g, leaves in grads.items() for n, v in leaves.items()}
    for out in outs:
        got = out["steps"][case]["grads"]
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.linalg.norm(got[path] - w) <= TOL * np.linalg.norm(w), path


def test_serve_engine_on_a_gathered_region(world):
    jax_side, inputs, _, outs = world
    tk = SimpleTokenizer(padding_side="left")
    tcfg = _cfg(_spec("text", tk), port_configs.get_model_config)
    eng = ServeEngine(tcfg, to_torch(jax_side["text"][1], "cpu"), num_slots=2, max_len=48,
                      prefill_buckets=(8, 16, 32), decode_block=2, device="cpu")
    for i, p in enumerate(inputs["engine"]["prompts"]):
        eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
    with torch.no_grad():
        want = [r.tokens for r in eng.run()]
    assert all(len(t) > 0 for t in want)
    for out in outs:
        assert out["engine"] == want
        assert out["engine_cache_heads"] == tcfg.text.num_kv_heads  # every KV head


def test_entry_points_on_a_gathered_region(world, tmp_path):
    """``run_train(use_mesh=True)`` with ``mesh.model_axis`` 4 (every rank's
    trained shift as one process's within 1e-5) and the eval's
    ``LVLMRunner.generate`` (beam 3) on a ``shard_params`` tree under the mesh
    (the one-process runner's strings)."""
    jax_side, inputs, _, outs = world
    run, ev = inputs["run"], inputs["eval"]
    cfg = _cfg(inputs["models"][run["model"]][0], port_configs.get_model_config)
    runner = LVLMRunner(cfg, to_torch(jax_side[run["model"]][1], "cpu"),
                        PortTokenizer(padding_side="left"), device="cpu", pad_multiple=32)
    state = run_train(tconfig.config_from_dict(tconfig.TrainConfig, run["cfg"]),
                      result_dir=str(tmp_path), runner=runner, splits=run["splits"])
    cfg = _cfg(inputs["models"][ev["model"]][0], port_configs.get_model_config)
    runner = LVLMRunner(cfg, to_torch(jax_side[ev["model"]][1], "cpu"),
                        PortTokenizer(padding_side="left"), device="cpu")
    with torch.no_grad():
        want = runner.generate(ev["images"], ev["texts"], num_beams=3, max_new_tokens=4)
    for out in outs:
        assert out["run_step"] == state.step > 0
        for name, w in state.trainable["shift"].items():
            np.testing.assert_allclose(out["run_trainable"]["shift"][name], w.detach().numpy(),
                                       rtol=TOL, atol=TOL, err_msg=name)
        assert out["eval"] == want
