"""The checkpoint converter and loader of mimic_tpu_torch against the JAX package and HF.

``models/convert.py`` turns an HF idefics2 state dict into the port's stacked
tree; ``models/factory.py::load_params`` / ``build_model(paths=...)`` read the
``params.msgpack`` it writes.  Held here:

- the port's ``convert_idefics2`` against JAX's (numpy) followed by
  ``bridge.to_torch``, bit for bit, in fp32 and in bf16, on a random HF-named
  state dict made from a random tree by ``chip_smoke.hf_state_dict`` (the
  inverse the chip run uses at 8B), which must give the tree back;
- the llava (both key layouts) and text-tower converters on tiny HF
  checkpoints against JAX's, bit for bit;
- the port's safetensors reader against the ``safetensors`` package;
- a tiny HF ``Idefics2ForConditionalGeneration`` built from configs in memory
  (as ``tests/test_hf_parity.py`` builds it), saved in several shards,
  converted and loaded through ``build_model(paths=...)``: logits within 2e-4
  of HF's, greedy and beam tokens identical;
- ``params.msgpack`` crossing between the two packages' ``load_params``;
- the seed/mme image-size override of ``build_model``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mimic_tpu.models import convert as jconvert
from mimic_tpu.models import factory as jfactory
from mimic_tpu.models.config import get_model_config
from mimic_tpu_torch.bridge import to_numpy, to_torch
from mimic_tpu_torch.config.paths import Paths
from mimic_tpu_torch.models import convert as tconvert
from mimic_tpu_torch.models import factory as tfactory
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models.lvlm import LVLMBatch, init_lvlm_params, lvlm_forward
from mimic_tpu_torch.models.tokenizer import SimpleTokenizer

TOL_HF = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg():
    tk = SimpleTokenizer()
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )
    return cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))


def _random_tree(cfg, dtype, seed=0):
    return init_lvlm_params(cfg, torch.Generator().manual_seed(seed), torch.device("cpu"), dtype)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_same_tree(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], path + (k,))
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    assert torch.equal(_bits(got), _bits(want)), path


def _np_state_dict(sd):
    """torch state dict → numpy, bf16 as JAX's ml_dtypes bfloat16."""
    return {k: to_numpy(v, bfloat16=jnp.bfloat16) for k, v in sd.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_convert_idefics2_matches_jax_bit_for_bit(dtype):
    cfg = _tiny_cfg()
    tree = _random_tree(cfg, dtype)
    sd = chip_smoke.hf_state_dict(tree, cfg)
    assert "lm_head.weight" in sd and "model.connector.perceiver_resampler.latents" in sd
    got = tconvert.convert_idefics2(sd, cfg)
    _assert_same_tree(got, tree)  # the helper is the converter's inverse
    want = to_torch(jconvert.convert_idefics2(_np_state_dict(sd), cfg), "cpu")
    _assert_same_tree(got, want)


@pytest.mark.parametrize("variant", ["attn_bias", "qk_layernorm", "class_token", "no_post_ln"])
def test_shared_converters_match_jax(variant):
    """``convert_decoder`` / ``convert_vit``'s branches that idefics2 does not
    take (the other families will) against JAX's, bit for bit."""
    cfg = _tiny_cfg()
    sd = chip_smoke.hf_state_dict(_random_tree(cfg, torch.float32), cfg)
    gen = torch.Generator().manual_seed(1)

    def add(name, *shape):
        sd[name] = torch.randn(shape, generator=gen)

    text, vision = cfg.text, cfg.vision
    if variant in ("attn_bias", "qk_layernorm"):
        text = dataclasses.replace(text, qk_layernorm=variant == "qk_layernorm")
        for i in range(text.num_layers):
            pre = f"model.text_model.layers.{i}.self_attn."
            for p, n in (("q", text.num_heads), ("k", text.num_kv_heads), ("v", text.num_kv_heads)):
                add(f"{pre}{p}_proj.bias", n * text.head_size)
            add(f"{pre}q_layer_norm.weight", text.head_size)
            add(f"{pre}k_layer_norm.weight", text.head_size)
        args = (sd, "model.text_model.", text, variant == "attn_bias")
        got, want = tconvert.convert_decoder(*args), jconvert.convert_decoder(
            _np_state_dict(sd), *args[1:])
    else:
        vision = dataclasses.replace(vision, use_class_token=variant == "class_token")
        pre = "model.vision_model."
        add(pre + "embeddings.class_embedding", vision.hidden_size)
        add(pre + "pre_layrnorm.weight", vision.hidden_size)
        add(pre + "pre_layrnorm.bias", vision.hidden_size)
        if variant == "class_token":
            del sd[pre + "embeddings.patch_embedding.bias"]  # CLIP towers have none
        post = variant != "no_post_ln"
        got = tconvert.convert_vit(sd, pre, vision, post_layernorm=post)
        want = jconvert.convert_vit(_np_state_dict(sd), pre, vision, post_layernorm=post)
    _assert_same_tree(got, to_torch(want, "cpu"))


def _released_llava_layout(sd):
    """The released llava checkpoints' key layout (``language_model.model.*``),
    which newer transformers versions write as ``model.language_model.*``."""
    renames = (("model.language_model.", "language_model.model."),
               ("model.vision_tower.", "vision_tower."),
               ("model.multi_modal_projector.", "multi_modal_projector."),
               ("lm_head.", "language_model.lm_head."))
    out = {}
    for k, v in sd.items():
        for old, new in renames:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["llava-interleave", "llava-1.5", "llava-released-layout",
                                  "qwen2", "mistral"])
def test_llava_and_text_converters_match_jax(case):
    """Tiny HF checkpoints (``LlavaForConditionalGeneration`` over Qwen2 + SigLIP
    and LLaMA + CLIP, in both key layouts; ``Qwen2ForCausalLM``,
    ``MistralForCausalLM``) through the port's converter and JAX's: the same
    tree, bit for bit (HF's logits: tests/test_torch_llava.py and
    tests/test_torch_text_towers.py)."""
    from test_torch_llava import hf_llava
    from test_torch_text_towers import hf_text

    if case.startswith("llava"):
        model, cfg = hf_llava("1.5" if case == "llava-1.5" else "interleave")
        convert = "convert_llava_interleave"
    else:
        model, cfg = hf_text(case, window=4 if case == "mistral" else None)
        convert = "convert_text"
    sd = model.state_dict()
    assert ("model.language_model.embed_tokens.weight" in sd) == case.startswith("llava")
    if case == "llava-released-layout":
        sd = _released_llava_layout(sd)
        assert "language_model.model.embed_tokens.weight" in sd
    got = getattr(tconvert, convert)(sd, cfg)
    want = to_torch(getattr(jconvert, convert)(_np_state_dict(sd), cfg), "cpu")
    _assert_same_tree(got, want)
    assert ("q_bias" in got["lm"]["decoder"]["layers"]) == cfg.text.attn_bias
    assert tconvert._CONVERTERS[cfg.family] is getattr(tconvert, convert)


def _st_tensors():
    gen = torch.Generator().manual_seed(2)
    return {
        "w.bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
        "w.f16": torch.randn(7, generator=gen).to(torch.float16),
        "w.f32": torch.randn(2, 3, 4, generator=gen),
        "ids.i64": torch.arange(-3, 6, dtype=torch.int64).reshape(3, 3),
        "scalar.f32": torch.tensor(1.5),
        "empty.f32": torch.zeros(0, 4),
    }


def test_safetensors_reader_matches_the_library(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy = pytest.importorskip("safetensors.numpy")
    tensors = _st_tensors()
    path = str(tmp_path / "a.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = tconvert.load_safetensors(path)
    want = st_torch.load_file(path)
    assert set(got) == set(want) == set(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    # numpy has no bfloat16: the library's numpy reader holds every other type
    path_np = str(tmp_path / "b.safetensors")
    st_numpy.save_file({k: v.numpy() for k, v in tensors.items() if k != "w.bf16"}, path_np)
    for k, v in st_numpy.load_file(path_np).items():
        np.testing.assert_array_equal(tconvert.load_safetensors(path_np)[k].numpy(), v)
    # the chip run's writer is read back by the library too
    path_w = str(tmp_path / "c.safetensors")
    chip_smoke.write_safetensors(path_w, tensors)
    for k, v in st_torch.load_file(path_w).items():
        assert torch.equal(_bits(v), _bits(tensors[k])), k


def test_safetensors_reader_rejects_what_it_cannot_read(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "i8.safetensors")
    st_torch.save_file({"q": torch.ones(4, dtype=torch.int8)}, path)
    with pytest.raises(ValueError, match="I8"):
        tconvert.load_safetensors(path)
    chip_smoke.write_safetensors(path, {"w": torch.ones(64)})
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-8])
    with pytest.raises(ValueError):
        tconvert.load_safetensors(path)


def test_state_dict_from_shards_and_bin(tmp_path):
    tensors = _st_tensors()
    names = sorted(tensors)
    st = tmp_path / "st"
    st.mkdir()
    for k, part in enumerate((names[:3], names[3:])):
        chip_smoke.write_safetensors(str(st / f"model-0000{k + 1}-of-00002.safetensors"),
                                     {n: tensors[n] for n in part})
    bins = tmp_path / "bin"
    bins.mkdir()
    torch.save(tensors, bins / "pytorch_model.bin")
    for d in (st, bins):
        got = tconvert.load_torch_state_dict(str(d))
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(_bits(got[k]), _bits(v)), (d, k)
    with pytest.raises(FileNotFoundError):
        tconvert.load_torch_state_dict(str(tmp_path))


def _write_checkpoint(tree, cfg, d, shards=2):
    sd = chip_smoke.hf_state_dict(tree, cfg)
    names = sorted(sd)
    step = -(-len(names) // shards)
    for k in range(shards):
        chip_smoke.write_safetensors(
            os.path.join(d, f"model-{k + 1:05d}-of-{shards:05d}.safetensors"),
            {n: sd[n] for n in names[k * step:(k + 1) * step]})


@pytest.fixture
def tiny_path(monkeypatch):
    """Tiny models have no path field of their own: read tiny-idefics2's
    weights from idefics2's for the test's duration."""
    monkeypatch.setitem(tfactory._MODEL_PATH_FIELD, "tiny-idefics2", "idefics2_8b_base_path")
    monkeypatch.setitem(jfactory._MODEL_PATH_FIELD, "tiny-idefics2", "idefics2_8b_base_path")


def test_params_msgpack_crosses_between_packages(tmp_path, tiny_path):
    cfg = _tiny_cfg()
    tree = _random_tree(cfg, torch.float32, seed=3)
    _write_checkpoint(tree, cfg, str(tmp_path))
    # the same shards through both converters: the same file, byte for byte
    ours = tconvert.convert_checkpoint("tiny-idefics2", str(tmp_path),
                                       str(tmp_path / "ours.msgpack"))
    theirs = jconvert.convert_checkpoint("tiny-idefics2", str(tmp_path),
                                         str(tmp_path / "theirs.msgpack"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    os.replace(ours, tmp_path / "params.msgpack")
    # the port's file read by JAX's load_params, and JAX's own tree by the port's
    got_jax = jfactory.load_params(cfg, str(tmp_path), dtype=jnp.float32)
    _assert_same_tree(to_torch(jax.tree.map(np.asarray, got_jax), "cpu"), tree)
    from flax import serialization

    jtree = jax.tree.map(np.asarray, jfactory.init_lvlm_params(cfg, jax.random.PRNGKey(4)))
    with open(tmp_path / "params.msgpack", "wb") as f:
        f.write(serialization.to_bytes(jtree))
    got = tfactory.load_params(cfg, str(tmp_path), dtype=torch.float32, device="cpu")
    _assert_same_tree(got, to_torch(jtree, "cpu"))


def test_load_params_checks_casts_and_falls_back(tmp_path, capsys):
    cfg = _tiny_cfg()
    random = tfactory.load_params(cfg, str(tmp_path), dtype=torch.float32, seed=7, device="cpu")
    _assert_same_tree(random, _random_tree(cfg, torch.float32, seed=7))
    assert "random" in capsys.readouterr().out
    tree = _random_tree(cfg, torch.float32, seed=3)
    _write_checkpoint(tree, cfg, str(tmp_path))
    tconvert.convert_checkpoint("tiny-idefics2", str(tmp_path))
    got = tfactory.load_params(cfg, str(tmp_path), dtype=torch.bfloat16, device="cpu")
    assert "params.msgpack" in capsys.readouterr().out
    _assert_same_tree(got, _random_tree(cfg, torch.bfloat16, seed=3))
    # a checkpoint of another shape is refused
    other = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=3))
    with pytest.raises(ValueError, match="shape"):
        tfactory.load_params(other, str(tmp_path), device="cpu")


@pytest.mark.parametrize("change,ok", [("hf_widths", True), ("mlp_mismatch", False),
                                       ("vision_width", False)])
def test_check_params_connector_widths(change, ok):
    """The connector's two MLP widths may be HF's (the modality projection the
    text tower's intermediate size, the perceiver layers 4 x its width) but
    must agree within each MLP; every other shape is the config's."""
    cfg = _tiny_cfg()
    tree = _random_tree(cfg, torch.float32)
    conn = tree["connector"]
    D, F, V = cfg.text.hidden_size, cfg.text.intermediate_size, cfg.vision.hidden_size
    L = cfg.perceiver.num_layers
    conn["modality_proj"] = {"gate": torch.zeros(V, F), "up": torch.zeros(V, F),
                             "down": torch.zeros(F, D)}
    conn["layers"].update(gate_proj=torch.zeros(L, D, 4 * D), up_proj=torch.zeros(L, D, 4 * D),
                          down_proj=torch.zeros(L, 4 * D, D))
    if change == "mlp_mismatch":
        conn["layers"]["down_proj"] = torch.zeros(L, 2 * D, D)
    elif change == "vision_width":
        conn["modality_proj"]["gate"] = torch.zeros(V + 1, F)
    if ok:
        tfactory.check_params(tree, cfg)
    else:
        with pytest.raises(ValueError, match="shape"):
            tfactory.check_params(tree, cfg)


@pytest.mark.parametrize("dataset,size", [("seedbench", 448), ("mme", 448), ("vqav2", None)])
def test_build_model_loads_weights_and_keeps_the_image_size_override(tmp_path, tiny_path,
                                                                     dataset, size):
    cfg = _tiny_cfg()
    tree = _random_tree(cfg, torch.float32, seed=3)
    _write_checkpoint(tree, cfg, str(tmp_path))
    tconvert.convert_checkpoint("tiny-idefics2", str(tmp_path))
    runner = tfactory.build_model("tiny-idefics2", dataset, paths=Paths(
        idefics2_8b_base_path=str(tmp_path)), device="cpu", dtype=torch.float32)
    _assert_same_tree(runner.params, tree)
    jrunner = jfactory.build_model("tiny-idefics2", dataset, paths=Paths(
        idefics2_8b_base_path=str(tmp_path)))
    img = np.zeros((60, 90, 3), np.uint8)
    got = runner.processor([[img]], ["<image>"])["pixel_values"].shape
    assert got == jrunner.processor([[img]], ["<image>"])["pixel_values"].shape
    assert max(got[2:4]) == (size or cfg.vision.image_size)


def test_convert_command_needs_no_jax_safetensors_or_transformers(tmp_path):
    cfg = _tiny_cfg()
    _write_checkpoint(_random_tree(cfg, torch.bfloat16, seed=6), cfg, str(tmp_path))
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "flax", "optax", "safetensors", "transformers", "msgpack"):
            sys.modules[name] = None  # any import of them now raises
        sys.argv = ["convert", "tiny-idefics2", {str(tmp_path)!r}]
        runpy.run_module("mimic_tpu_torch.models.convert", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert os.path.exists(tmp_path / "params.msgpack") and "converted" in out.stdout
    got = tfactory.load_params(cfg, str(tmp_path), dtype=torch.bfloat16, device="cpu")
    _assert_same_tree(got, _random_tree(cfg, torch.bfloat16, seed=6))


def test_cli_builds_the_model_for_its_dataset(monkeypatch):
    from mimic_tpu_torch.pipeline import cli

    seen = {}

    def fake_build_model(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise RuntimeError("stop")

    monkeypatch.setattr(tfactory, "build_model", fake_build_model)
    with pytest.raises(RuntimeError, match="stop"):
        cli._eval(["model_name=idefics2-8b-base", "data.name=seedbench", "device=cpu"])
    assert seen["args"] == ("idefics2-8b-base", "seedbench")
    with pytest.raises(RuntimeError, match="stop"):
        cli._pipeline(["-r", "x", "-m", "idefics2-8b-base", "-d", "mme", "--device", "cpu"])
    assert seen["args"] == ("idefics2-8b-base", "mme")


def test_hf_checkpoint_in_shards_through_build_model(tmp_path, tiny_path):
    """A tiny HF idefics2 at tiny-idefics2's widths, saved by ``save_pretrained``
    in several safetensors shards, converted by the port and loaded through
    ``build_model(paths=...)``: HF's logits within 2e-4, greedy and beam
    tokens identical (compared up to the first EOS, as in
    ``tests/test_hf_parity.py``)."""
    pytest.importorskip("transformers")
    from transformers.models.idefics2.configuration_idefics2 import (
        Idefics2Config, Idefics2PerceiverConfig, Idefics2VisionConfig,
    )
    from transformers.models.idefics2.modeling_idefics2 import Idefics2ForConditionalGeneration
    from transformers.models.mistral.configuration_mistral import MistralConfig

    cfg = _tiny_cfg()
    t, v, p = cfg.text, cfg.vision, cfg.perceiver
    torch.manual_seed(0)
    hf_cfg = Idefics2Config(
        text_config=MistralConfig(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
            num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
            num_key_value_heads=t.num_kv_heads, rms_norm_eps=t.norm_eps,
            max_position_embeddings=512, attn_implementation="eager"),
        vision_config=Idefics2VisionConfig(
            hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
            image_size=v.image_size, patch_size=v.patch_size, hidden_act="gelu_pytorch_tanh"),
        perceiver_config=Idefics2PerceiverConfig(
            resampler_n_latents=p.num_latents, resampler_depth=p.num_layers,
            resampler_n_heads=p.num_heads, resampler_head_dim=t.hidden_size // p.num_heads,
            num_key_value_heads=p.num_heads, hidden_act="silu"),
        image_token_id=cfg.image_token_id, tie_word_embeddings=False,
    )
    hf_cfg._attn_implementation = "eager"
    model = Idefics2ForConditionalGeneration(hf_cfg).eval().float()
    model.save_pretrained(str(tmp_path), max_shard_size="100KB", safe_serialization=True)
    shards = [f for f in os.listdir(tmp_path) if f.endswith(".safetensors")]
    assert len(shards) >= 2
    tconvert.convert_checkpoint("tiny-idefics2", str(tmp_path))
    runner = tfactory.build_model("tiny-idefics2", paths=Paths(idefics2_8b_base_path=str(tmp_path)),
                                  device="cpu", dtype=torch.float32)
    # HF's widths for the connector's two MLPs, not the config's one
    assert runner.params["connector"]["layers"]["gate_proj"].shape[-1] == 4 * t.hidden_size
    assert runner.params["connector"]["modality_proj"]["gate"].shape[-1] == t.intermediate_size

    B, T, S = 2, 14, cfg.image_seq_len
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 250, size=(B, T)).astype(np.int64)
    ids[:, 2:2 + S] = cfg.image_token_id
    pixels = rng.normal(size=(B, 1, 3, v.image_size, v.image_size)).astype(np.float32)
    hf_in = dict(input_ids=torch.tensor(ids), attention_mask=torch.ones(B, T, dtype=torch.long),
                 pixel_values=torch.tensor(pixels),
                 pixel_attention_mask=torch.ones(B, 1, v.image_size, v.image_size,
                                                 dtype=torch.long))
    ng = v.image_size // v.patch_size
    batch = LVLMBatch(input_ids=torch.tensor(ids), attention_mask=torch.ones(B, T, dtype=torch.int32),
                      pixel_values=torch.tensor(pixels.transpose(0, 1, 3, 4, 2).copy()),
                      patch_mask=torch.ones(B, 1, ng, ng, dtype=torch.int32))
    with torch.no_grad():
        hf_logits = model(**hf_in).logits
        ours = lvlm_forward(runner.params, runner.cfg, batch).logits
    np.testing.assert_allclose(ours.numpy(), hf_logits.numpy(), rtol=TOL_HF, atol=TOL_HF)

    eos, pad = cfg.eos_token_id, cfg.pad_token_id

    def until_eos(row):
        out = []
        for tok in row:
            out.append(int(tok))
            if tok == eos:
                break
        return out

    gen = dict(max_new_tokens=6, do_sample=False, pad_token_id=pad, eos_token_id=eos,
               bos_token_id=cfg.bos_token_id)
    with torch.no_grad():
        hf_greedy = model.generate(**hf_in, **gen)[:, T:]
        hf_beam = model.generate(**hf_in, **gen, num_beams=3, length_penalty=0.0,
                                 early_stopping=False)[:, T:]
    greedy = tg.greedy_generate(runner.params, runner.cfg, batch, 6, eos, pad).tokens
    beam = tg.beam_generate(runner.params, runner.cfg, batch, 6, 3, eos, pad,
                            length_penalty=0.0).tokens
    assert [until_eos(r) for r in greedy] == [until_eos(r) for r in hf_greedy]
    assert [until_eos(r) for r in beam] == [until_eos(r) for r in hf_beam]
