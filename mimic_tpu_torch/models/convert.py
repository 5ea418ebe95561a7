"""HF checkpoint → the port's stacked parameter tree (counterpart of
``mimic_tpu/models/convert.py``).

Reads a local HF checkpoint directory (``*.safetensors``, one file or
``model-0000k-of-0000n`` shards; else ``*.bin``) into torch tensors, keeping
their dtype (a bf16 checkpoint stays bf16), converts it to the tree that
``models/lvlm.py`` consumes, and writes ``params.msgpack`` in the flax format
(``train/checkpoints.py::tree_to_bytes``), which ``models/factory.py::load_params``
of either package reads.

Layout notes:

- torch ``nn.Linear.weight`` is ``[out, in]``; the tree's kernels are ``[in, out]``;
- per-layer weights are stacked along a leading ``[L]`` axis;
- conv patch embeddings ``[D, C, p, p]`` become dense kernels ``[p*p*C, D]``
  matching ``vision.patchify``'s ``[p, p, C]`` row-major flattening;
- IDEFICS-1's decoupled embeddings (base + additional trainable rows) are
  merged into one embedding / lm-head matrix.

Neither ``safetensors`` nor ``transformers`` is needed: ``load_safetensors``
reads the format itself (an 8-byte little-endian header length, a JSON header,
then the raw little-endian buffers).  Every family of ``models/config.py``
has its converter: idefics2, idefics1, llava-interleave (llava-interleave-7b
and llava-1.5-7b, either transformers key layout) and the text-only towers.

Run: ``python -m mimic_tpu_torch.models.convert <model_name> <hf_checkpoint_dir>``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..train.checkpoints import numpy_tree, tree_to_bytes
from .config import ModelConfig, get_model_config

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names → torch dtypes (the types an LVLM checkpoint holds)
_ST_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I64": torch.int64,
}


def load_safetensors(path: str) -> StateDict:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated file")
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dtype, shape = _ST_DTYPES[info["dtype"]], tuple(info["shape"])
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} spans bytes {start}-{end}, "
                             f"not {count} x {itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # a slice of its own (a copy): the tensor owns its bytes, aligned
        out[name] = torch.frombuffer(data[start:end], dtype=dtype, count=count).reshape(shape)
    return out


def load_torch_state_dict(path: str) -> StateDict:
    """All weights of an HF checkpoint directory, as CPU tensors."""
    state: StateDict = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            state.update(load_safetensors(os.path.join(path, f)))
        return state
    bin_files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"No safetensors/bin weights under {path}")
    for f in bin_files:
        state.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    return state


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.T.contiguous()


def _identity(w: torch.Tensor) -> torch.Tensor:
    return w


def _stack(sd: StateDict, pattern: str, n: int, transform: Callable = _t) -> torch.Tensor:
    return torch.stack([transform(sd[pattern.format(i=i)]) for i in range(n)])


def _conv_to_dense(w: torch.Tensor) -> torch.Tensor:
    """[D, C, p, p] conv kernel → [p*p*C, D] dense kernel for patchify order."""
    d, c, ph, pw = w.shape
    return w.permute(2, 3, 1, 0).reshape(ph * pw * c, d).contiguous()


def convert_decoder(sd: StateDict, prefix: str, cfg, attn_bias: bool) -> Dict:
    L = cfg.num_layers
    layers = {
        "input_ln": _stack(sd, prefix + "layers.{i}.input_layernorm.weight", L, _identity),
        "q_proj": _stack(sd, prefix + "layers.{i}.self_attn.q_proj.weight", L),
        "k_proj": _stack(sd, prefix + "layers.{i}.self_attn.k_proj.weight", L),
        "v_proj": _stack(sd, prefix + "layers.{i}.self_attn.v_proj.weight", L),
        "o_proj": _stack(sd, prefix + "layers.{i}.self_attn.o_proj.weight", L),
        "post_ln": _stack(
            sd, prefix + "layers.{i}.post_attention_layernorm.weight", L, _identity
        ),
        "gate_proj": _stack(sd, prefix + "layers.{i}.mlp.gate_proj.weight", L),
        "up_proj": _stack(sd, prefix + "layers.{i}.mlp.up_proj.weight", L),
        "down_proj": _stack(sd, prefix + "layers.{i}.mlp.down_proj.weight", L),
    }
    if attn_bias:
        layers["q_bias"] = _stack(sd, prefix + "layers.{i}.self_attn.q_proj.bias", L, _identity)
        layers["k_bias"] = _stack(sd, prefix + "layers.{i}.self_attn.k_proj.bias", L, _identity)
        layers["v_bias"] = _stack(sd, prefix + "layers.{i}.self_attn.v_proj.bias", L, _identity)
    if cfg.qk_layernorm:
        layers["q_ln"] = _stack(
            sd, prefix + "layers.{i}.self_attn.q_layer_norm.weight", L, _identity
        )
        layers["k_ln"] = _stack(
            sd, prefix + "layers.{i}.self_attn.k_layer_norm.weight", L, _identity
        )
    return {"layers": layers, "final_ln": sd[prefix + "norm.weight"]}


def convert_vit(sd: StateDict, prefix: str, vcfg, post_layernorm: bool = True) -> Dict:
    L = vcfg.num_layers
    enc = prefix + "encoder.layers.{i}."
    p: Dict = {
        "patch_embed": {
            "kernel": _conv_to_dense(sd[prefix + "embeddings.patch_embedding.weight"]),
            # CLIP-style towers (idefics1) have no patch-conv bias
            "bias": sd.get(
                prefix + "embeddings.patch_embedding.bias",
                torch.zeros(vcfg.hidden_size, dtype=torch.float32),
            ),
        },
        "pos_embed": sd[prefix + "embeddings.position_embedding.weight"],
        "layers": {
            "ln1_w": _stack(sd, enc + "layer_norm1.weight", L, _identity),
            "ln1_b": _stack(sd, enc + "layer_norm1.bias", L, _identity),
            "q_proj": _stack(sd, enc + "self_attn.q_proj.weight", L),
            "q_bias": _stack(sd, enc + "self_attn.q_proj.bias", L, _identity),
            "k_proj": _stack(sd, enc + "self_attn.k_proj.weight", L),
            "k_bias": _stack(sd, enc + "self_attn.k_proj.bias", L, _identity),
            "v_proj": _stack(sd, enc + "self_attn.v_proj.weight", L),
            "v_bias": _stack(sd, enc + "self_attn.v_proj.bias", L, _identity),
            "o_proj": _stack(sd, enc + "self_attn.out_proj.weight", L),
            "o_bias": _stack(sd, enc + "self_attn.out_proj.bias", L, _identity),
            "ln2_w": _stack(sd, enc + "layer_norm2.weight", L, _identity),
            "ln2_b": _stack(sd, enc + "layer_norm2.bias", L, _identity),
            "fc1": _stack(sd, enc + "mlp.fc1.weight", L),
            "fc1_bias": _stack(sd, enc + "mlp.fc1.bias", L, _identity),
            "fc2": _stack(sd, enc + "mlp.fc2.weight", L),
            "fc2_bias": _stack(sd, enc + "mlp.fc2.bias", L, _identity),
        },
        # llava takes vision_feature_layer=-2: features leave the tower BEFORE
        # the final norm, so the converted post-layernorm becomes identity
        "post_ln_w": (
            sd[prefix + "post_layernorm.weight"]
            if post_layernorm
            else torch.ones(vcfg.hidden_size, dtype=torch.float32)
        ),
        "post_ln_b": (
            sd[prefix + "post_layernorm.bias"]
            if post_layernorm
            else torch.zeros(vcfg.hidden_size, dtype=torch.float32)
        ),
    }
    if vcfg.use_class_token:
        p["class_embed"] = sd[prefix + "embeddings.class_embedding"].reshape(-1)
        p["pre_ln_w"] = sd[prefix + "pre_layrnorm.weight"]  # HF CLIP typo
        p["pre_ln_b"] = sd[prefix + "pre_layrnorm.bias"]
    return p


def convert_idefics2(sd: StateDict, cfg: ModelConfig) -> Dict:
    lm = convert_decoder(sd, "model.text_model.", cfg.text, attn_bias=False)
    return {
        "lm": {
            "embed": sd["model.text_model.embed_tokens.weight"],
            "decoder": lm,
            "lm_head": _t(sd["lm_head.weight"]),
        },
        "vision": convert_vit(sd, "model.vision_model.", cfg.vision),
        "connector": _convert_idefics2_connector(sd, cfg),
    }


def _convert_idefics2_connector(sd: StateDict, cfg: ModelConfig) -> Dict:
    L = cfg.perceiver.num_layers
    pre = "model.connector.perceiver_resampler."
    lay = pre + "layers.{i}."
    return {
        "latents": sd[pre + "latents"],
        "modality_proj": {
            "gate": _t(sd["model.connector.modality_projection.gate_proj.weight"]),
            "up": _t(sd["model.connector.modality_projection.up_proj.weight"]),
            "down": _t(sd["model.connector.modality_projection.down_proj.weight"]),
        },
        "layers": {
            "ln_latents": _stack(sd, lay + "input_latents_norm.weight", L, _identity),
            "ln_context": _stack(sd, lay + "input_context_norm.weight", L, _identity),
            "q_proj": _stack(sd, lay + "self_attn.q_proj.weight", L),
            "k_proj": _stack(sd, lay + "self_attn.k_proj.weight", L),
            "v_proj": _stack(sd, lay + "self_attn.v_proj.weight", L),
            "o_proj": _stack(sd, lay + "self_attn.o_proj.weight", L),
            "post_ln": _stack(sd, lay + "post_attention_layernorm.weight", L, _identity),
            "gate_proj": _stack(sd, lay + "mlp.gate_proj.weight", L),
            "up_proj": _stack(sd, lay + "mlp.up_proj.weight", L),
            "down_proj": _stack(sd, lay + "mlp.down_proj.weight", L),
        },
        "final_ln": sd[pre + "norm.weight"],
    }


def convert_idefics1(sd: StateDict, cfg: ModelConfig) -> Dict:
    """IDEFICS-1: the decoder, its gated cross layers (one per
    ``cross_attn_interval`` layers), the CLIP tower and the perceiver
    resampler; DecoupledEmbedding / DecoupledLinear extra rows merged."""
    text = cfg.text
    lm = convert_decoder(sd, "model.", text, attn_bias=False)
    embed = sd["model.embed_tokens.weight"]
    if "model.embed_tokens.additional_embedding.weight" in sd:
        embed = torch.cat([embed, sd["model.embed_tokens.additional_embedding.weight"]], 0)
    head = _t(sd["lm_head.weight"])
    if "lm_head.additional_fc.weight" in sd:
        head = torch.cat([head, _t(sd["lm_head.additional_fc.weight"])], 1)

    G = text.num_cross_layers
    pre = "model.gated_cross_attn_layers.{i}."
    cross = {
        "input_ln": _stack(sd, pre + "input_layernorm.weight", G, _identity),
        "q_proj": _stack(sd, pre + "cross_attn.q_proj.weight", G),
        "k_proj": _stack(sd, pre + "cross_attn.k_proj.weight", G),
        "v_proj": _stack(sd, pre + "cross_attn.v_proj.weight", G),
        "o_proj": _stack(sd, pre + "cross_attn.o_proj.weight", G),
        "post_ln": _stack(sd, pre + "post_attention_layernorm.weight", G, _identity),
        "gate_proj": _stack(sd, pre + "mlp.gate_proj.weight", G),
        "up_proj": _stack(sd, pre + "mlp.up_proj.weight", G),
        "down_proj": _stack(sd, pre + "mlp.down_proj.weight", G),
        "alpha_attn": _stack(sd, pre + "alpha_cross_attn", G, lambda w: w.reshape(())),
        "alpha_dense": _stack(sd, pre + "alpha_dense", G, lambda w: w.reshape(())),
    }
    if text.cross_qk_layernorm:
        cross["q_ln"] = _stack(sd, pre + "cross_attn.q_layer_norm.weight", G, _identity)
        cross["k_ln"] = _stack(sd, pre + "cross_attn.k_layer_norm.weight", G, _identity)
    lm["cross"] = cross

    # HF IdeficsPerceiverResampler: blocks.{i}.0 the attention (context / latents
    # layer norms, q/k/v/output_proj, optional qk layer norms), blocks.{i}.1 the
    # ReLU MLP (ln, fc, c_proj), then a final layer_norm
    pv = "model.perceiver_resampler."
    blk = pv + "blocks.{i}."
    L = cfg.perceiver.num_layers
    layers = {
        "ln_context_w": _stack(sd, blk + "0.context_layer_norm.weight", L, _identity),
        "ln_context_b": _stack(sd, blk + "0.context_layer_norm.bias", L, _identity),
        "ln_latents_w": _stack(sd, blk + "0.latents_layer_norm.weight", L, _identity),
        "ln_latents_b": _stack(sd, blk + "0.latents_layer_norm.bias", L, _identity),
        "q_proj": _stack(sd, blk + "0.q_proj.weight", L),
        "k_proj": _stack(sd, blk + "0.k_proj.weight", L),
        "v_proj": _stack(sd, blk + "0.v_proj.weight", L),
        "o_proj": _stack(sd, blk + "0.output_proj.weight", L),
        "mlp_ln_w": _stack(sd, blk + "1.ln.weight", L, _identity),
        "mlp_ln_b": _stack(sd, blk + "1.ln.bias", L, _identity),
        "fc": _stack(sd, blk + "1.fc.weight", L),
        "c_proj": _stack(sd, blk + "1.c_proj.weight", L),
    }
    if pv + "blocks.0.0.q_layer_norm.weight" in sd:
        layers["q_ln_w"] = _stack(sd, blk + "0.q_layer_norm.weight", L, _identity)
        layers["q_ln_b"] = _stack(sd, blk + "0.q_layer_norm.bias", L, _identity)
        layers["k_ln_w"] = _stack(sd, blk + "0.k_layer_norm.weight", L, _identity)
        layers["k_ln_b"] = _stack(sd, blk + "0.k_layer_norm.bias", L, _identity)
    perceiver = {
        "latents": sd[pv + "latents"],
        "layers": layers,
        "final_ln_w": sd[pv + "layer_norm.weight"],
        "final_ln_b": sd[pv + "layer_norm.bias"],
    }
    return {
        "lm": {"embed": embed, "decoder": lm, "lm_head": head},
        "vision": convert_vit(sd, "model.vision_model.", cfg.vision),
        "perceiver": perceiver,
    }


def _normalize_llava_keys(sd: StateDict) -> StateDict:
    """Map the newer transformers layout (``model.language_model.*``) onto the
    released checkpoints' layout (``language_model.model.*``) that
    ``convert_llava_interleave`` reads."""
    if "model.language_model.embed_tokens.weight" not in sd:
        return sd
    renames = (("model.language_model.", "language_model.model."),
               ("model.vision_tower.", "vision_tower."),
               ("model.multi_modal_projector.", "multi_modal_projector."))
    out = {}
    for k, v in sd.items():
        for old, new in renames:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    if "lm_head.weight" in sd:
        out["language_model.lm_head.weight"] = sd["lm_head.weight"]
    return out


def convert_llava_interleave(sd: StateDict, cfg: ModelConfig) -> Dict:
    """LLaVA: the text tower (qwen2 with q/k/v biases for llava-interleave,
    llama for llava-1.5), the vision tower's first ``cfg.vision.num_layers``
    layers with an identity post-layernorm, and the projector."""
    sd = _normalize_llava_keys(sd)
    lm = convert_decoder(sd, "language_model.model.", cfg.text, attn_bias=cfg.text.attn_bias)
    return {
        "lm": {
            "embed": sd["language_model.model.embed_tokens.weight"],
            "decoder": lm,
            "lm_head": _t(sd["language_model.lm_head.weight"]),
        },
        "vision": convert_vit(sd, "vision_tower.vision_model.", cfg.vision, post_layernorm=False),
        "projector": {
            "fc1": _t(sd["multi_modal_projector.linear_1.weight"]),
            "fc1_bias": sd["multi_modal_projector.linear_1.bias"],
            "fc2": _t(sd["multi_modal_projector.linear_2.weight"]),
            "fc2_bias": sd["multi_modal_projector.linear_2.bias"],
        },
    }


def convert_text(sd: StateDict, cfg: ModelConfig) -> Dict:
    """A plain HF causal LM (``MistralForCausalLM`` / ``Qwen2ForCausalLM``)."""
    out = {"lm": {"embed": sd["model.embed_tokens.weight"],
                  "decoder": convert_decoder(sd, "model.", cfg.text,
                                             attn_bias=cfg.text.attn_bias)}}
    if not cfg.text.tie_word_embeddings:
        out["lm"]["lm_head"] = _t(sd["lm_head.weight"])
    return out


_CONVERTERS = {
    "idefics2": convert_idefics2,
    "llava-interleave": convert_llava_interleave,
    "idefics1": convert_idefics1,
    "text": convert_text,
}


def convert_checkpoint(model_name: str, hf_dir: str, out_path: Optional[str] = None) -> str:
    """``hf_dir``'s weights → ``params.msgpack`` (next to them by default),
    keys in the tree's own order, as ``flax.serialization.to_bytes`` of the
    JAX converter's dict writes them."""
    cfg = get_model_config(model_name)
    params = _CONVERTERS[cfg.family](load_torch_state_dict(hf_dir), cfg)
    out_path = out_path or os.path.join(hf_dir, "params.msgpack")
    with open(out_path, "wb") as f:
        f.write(tree_to_bytes(numpy_tree(params, sort_keys=False)))
    return out_path


if __name__ == "__main__":
    import sys

    print(f"converted: {convert_checkpoint(sys.argv[1], sys.argv[2])}")
