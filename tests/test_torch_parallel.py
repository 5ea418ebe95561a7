"""mimic_tpu_torch.parallel against the JAX package's ``mimic_tpu.parallel``.

The partition rules give every leaf of tiny-idefics2, tiny-idefics1 and
tiny-llava-interleave (and of a tiny-idefics2 whose 255-row vocab does not
split) the same split at ``model`` 2 as JAX's ``param_shardings``;
``make_mesh`` raises JAX's ``ValueError`` for a layout that is not the world,
and a ``RuntimeError`` without a process group.  ``lvlm_forward`` on a
(data 2 x model 2) mesh of four ``gloo`` processes, each holding its
``shard_params`` tree and its ``shard_batch`` rows, gives the logits of the
single-device JAX forward within 2e-4 in fp32 (JAX's own bound in
``tests/test_parallel.py``): text only, with the MimIC shift (multi-head and
the flat form) and with images through each family's tower, connector and
projector.  The world is spawned once for the module and runs every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import EncoderConfig, get_preset
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.parallel import make_mesh as jax_make_mesh
from mimic_tpu.parallel import param_shardings as jax_param_shardings
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch import parallel
from torch_dist import run_world

TOL = 2e-4
MODELS = {
    "idefics2": "tiny-idefics2",
    "idefics1": "tiny-idefics1",
    "llava": "tiny-llava-interleave",
    "idefics2-v255": "tiny-idefics2",
}
FLAT_SHIFT = EncoderConfig(
    kind="attn_approximator", model_strategy="Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE",
    attn_strategy="ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE",
    ffn_strategy="ShiftStrategy.RECORD_HIDDEN_STATES",
)


def _spec(key, tk):
    """(name, top-level fields, text fields) of a model, as the workers rebuild it."""
    top = dict(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
               bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return MODELS[key], top, {"vocab_size": 255 if key.endswith("v255") else tk.vocab_size}


def _cfg(spec):
    name, top, text = spec
    cfg = get_model_config(name).replace(**top)
    return cfg.replace(text=dataclasses.replace(cfg.text, **text))


def _params(cfg, seed):
    """JAX's initialisers; every bias and layer-norm offset drawn away from zero
    (a replicated bias of a sharded region must be sliced or added once) and
    idefics1's gates opened, so that the images reach the logits."""
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(seed)))
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


@pytest.fixture(scope="module")
def world(tmp_path_factory, eight_devices):
    tk = SimpleTokenizer(padding_side="left")
    models, jax_side = {}, {}
    for i, key in enumerate(MODELS):
        spec = _spec(key, tk)
        cfg = _cfg(spec)
        params = _params(cfg, i)
        models[key] = (spec, params)
        jax_side[key] = (cfg, params)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 250, size=(4, 16)).astype(np.int32)
    text = {"input_ids": ids, "attention_mask": np.ones((4, 16), np.int32)}
    mimic, _ = get_preset("mimic")
    cfg2 = jax_side["idefics2"][0]
    shifts = {mh: jax.tree.map(lambda x: np.asarray(x) * 50.0, init_shift_params(
        enc, cfg2.text, jax.random.PRNGKey(1))) for mh, enc in ((True, mimic), (False, FLAT_SHIFT))}
    texts = [f"Image:<image> what is shown in picture {i}? Answer:" for i in range(4)]
    fields = {"idefics2": ("input_ids", "attention_mask", "pixel_values", "patch_mask"),
              "idefics1": ("input_ids", "attention_mask", "pixel_values", "pixel_mask",
                           "image_attention_mask"),
              "llava": ("input_ids", "attention_mask", "pixel_values")}
    forward = {
        "text": {"model": "idefics2", "batch": text, "shift": None, "multi_head": True},
        "text-vocab255": {"model": "idefics2-v255", "batch": text, "shift": None,
                          "multi_head": True},
        "shift": {"model": "idefics2", "batch": text, "shift": shifts[True], "multi_head": True},
        "flat-shift": {"model": "idefics2", "batch": text, "shift": shifts[False],
                       "multi_head": False},
    }
    for key, names in fields.items():
        enc = LVLMProcessor(jax_side[key][0], tk)(_images(4), texts)
        batch = {k: np.asarray(enc[k]) for k in names if enc.get(k) is not None}
        forward[f"images-{key}"] = {"model": key, "batch": batch,
                                    "shift": shifts[True] if key == "idefics2" else None,
                                    "multi_head": True}
    outs = run_world("torch_workers:parallel_world", 4, tmp_path_factory.mktemp("parallel"),
                     {"models": models, "forward": forward})
    return jax_side, forward, outs


@pytest.mark.parametrize("key", list(MODELS))
def test_rules_match_jax(world, eight_devices, key):
    jax_side, _, outs = world
    cfg, params = jax_side[key]
    specs = jax_param_shardings(params, jax_make_mesh(4, 2, eight_devices))
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: hasattr(x, "spec"))}
    for out in outs:
        assert out["specs"][key] == want
    split = [p for p, s in want.items() if "model" in s]
    assert split and any("lm_head" in p for p in split) != key.endswith("v255")


def test_mesh_layout_and_errors(world):
    _, _, outs = world
    assert [tuple(o["coord"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["mesh_error"] == "mesh 3x1 != 4 devices" for o in outs)
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        jax_make_mesh(3, 1, jax.devices()[:4])
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(1, 1, device_type="cpu")


def test_specs_print_like_jax():
    assert repr(parallel.mesh.P(None, "model")) == repr(jax.sharding.PartitionSpec(None, "model"))
    assert parallel.replicated(None) == parallel.mesh.P()


@pytest.mark.parametrize("case", ["text", "text-vocab255", "shift", "flat-shift",
                                  "images-idefics2", "images-idefics1", "images-llava"])
def test_sharded_forward_matches_single_device_jax(world, case):
    jax_side, forward, outs = world
    spec = forward[case]
    cfg, params = jax_side[spec["model"]]
    batch = jlvlm.LVLMBatch(**{k: jnp.asarray(v) for k, v in spec["batch"].items()})
    want = np.asarray(jlvlm.lvlm_forward(params, cfg, batch, shift=spec["shift"],
                                         multi_head=spec["multi_head"]).logits)
    for rank, out in enumerate(outs):
        d = rank // 2  # data coordinate; both model ranks hold the whole logits
        np.testing.assert_allclose(out["logits"][case], want[2 * d:2 * d + 2], rtol=TOL, atol=TOL)
    if spec["shift"] is not None:
        plain = np.asarray(jlvlm.lvlm_forward(params, cfg, batch).logits)
        assert np.abs(plain - want).max() > 1e-2  # the shift moves the logits


def test_shard_batch_and_params_blocks():
    """Without a group: the blocks a 2 x 2 mesh would give, through a stand-in
    that has the mesh's names, shape and this rank's coordinates."""

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.arange(4).reshape(2, 2)

        def get_local_rank(self, axis):
            return {"data": 1, "model": 0}[axis]

    rows = parallel.shard_batch({"x": np.arange(8).reshape(4, 2), "y": None}, Mesh())
    np.testing.assert_array_equal(rows["x"], [[4, 5], [6, 7]])
    assert rows["y"] is None
    tree = {"layers": {"q_proj": torch.arange(2 * 4 * 6.0).reshape(2, 4, 6),
                       "input_ln": torch.ones(2, 4)}, "embed": torch.arange(10.0)[:, None]}
    cut = parallel.shard_params(tree, Mesh())
    assert torch.equal(cut["layers"]["q_proj"], tree["layers"]["q_proj"][..., :3])
    assert cut["layers"]["input_ln"] is tree["layers"]["input_ln"]
    assert torch.equal(cut["embed"], tree["embed"][:5])
    with pytest.raises(ValueError, match="do not split"):
        parallel.shard_batch({"x": np.zeros((3, 1))}, Mesh())
