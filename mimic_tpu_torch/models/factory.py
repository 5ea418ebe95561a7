"""Model factory — ``build_model`` (counterpart of ``mimic_tpu/models/factory.py``).

Builds an ``LVLMRunner`` for a named model: the architecture config, the
parameters (``params.msgpack`` converted by ``models/convert.py`` from the
model's configured path, else random ones at the config's shapes made on the
device from a seeded ``torch.Generator``), the tokenizer (HF's from the
model's path when it holds one, else the self-contained byte tokenizer), and
the idefics2 image-resolution override for seed/mme.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..bridge import tree_leaves, tree_map
from ..config.paths import Paths, get_paths
from ..device import DeviceLike, resolve_device
from ..train.checkpoints import _bf16_bits_to_torch, _check_like, tree_from_bytes
from .config import ModelConfig, get_model_config
from .lvlm import init_lvlm_params
from .runner import LVLMRunner
from .tokenizer import HFTokenizerAdapter, SimpleTokenizer

_MODEL_PATH_FIELD = {
    "idefics-9b": "idefics_9b_path",
    "idefics2-8b-base": "idefics2_8b_base_path",
    "llava-interleave-7b": "llava_interleave_7b_path",
}
PARAMS_FILE = "params.msgpack"


def load_params(
    cfg: ModelConfig,
    path: Optional[str],
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """``<path>/params.msgpack`` on ``device`` when it exists, else random
    parameters from ``seed``; prints which.  A loaded tree must have the
    config's keys and shapes (``check_params``) and floating-point leaves,
    which are cast to ``dtype`` where the checkpoint holds another."""
    dev = resolve_device(device)
    ckpt = os.path.join(path, PARAMS_FILE) if path else None
    if ckpt is None or not os.path.exists(ckpt):
        print(f"[build_model] {cfg.name}: no {PARAMS_FILE} under {path!r}; "
              f"random {dtype} parameters from seed {seed}")
        return init_lvlm_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, dtype)
    with open(ckpt, "rb") as f:
        tree = _bf16_bits_to_torch(tree_from_bytes(f.read()), torch.device("cpu"))
    check_params(tree, cfg)
    stored = {str(t.dtype) for t in tree_leaves(tree)}
    if not all(t.is_floating_point() for t in tree_leaves(tree)):
        raise ValueError(f"{ckpt}: a leaf is not floating point ({sorted(stored)})")
    print(f"[build_model] {cfg.name}: parameters from {ckpt} ({', '.join(sorted(stored))} "
          f"as {dtype})")
    return tree_map(lambda t: t.to(dev, dtype), tree)


# the connector's two MLPs: (path, gate / up / down leaves)
_CONNECTOR_MLPS = ((("connector", "modality_proj"), ("gate", "up", "down")),
                   (("connector", "layers"), ("gate_proj", "up_proj", "down_proj")))


def check_params(tree: Dict[str, Any], cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``tree`` has the keys and leaf shapes of
    ``cfg``'s parameters (compared with a tree made on the meta device, so no
    second tree is allocated).  One axis is read from the tree itself: the
    config holds one ``intermediate_size`` for the connector's two MLPs, where
    HF's Idefics2 gives them two (the modality projection the text tower's
    intermediate size, the perceiver layers 4 x the text width), so each MLP's
    width is taken from its gate and held across its three leaves."""
    want = init_lvlm_params(cfg, None, torch.device("meta"))
    for path, (gate, up, down) in _CONNECTOR_MLPS:
        node, ref = tree, want
        for k in path:
            node = node.get(k, {}) if isinstance(node, dict) else {}
            ref = ref.get(k, {})
        if gate not in node or gate not in ref:
            continue  # no connector in this family, or _check_like names the missing key
        width = node[gate].shape[-1]
        for name, shape in ((gate, ref[gate].shape[:-1] + (width,)),
                            (up, ref[up].shape[:-1] + (width,)),
                            (down, ref[down].shape[:-2] + (width, ref[down].shape[-1]))):
            ref[name] = torch.empty(shape, device="meta")
    _check_like(tree, want, ())


def build_tokenizer(cfg: ModelConfig, path: Optional[str]):
    if path and os.path.exists(os.path.join(path, "tokenizer_config.json")):
        return HFTokenizerAdapter.from_pretrained(path)
    return SimpleTokenizer()


def build_model(
    model_name: str,
    dataset_name: str = "",
    paths: Optional[Paths] = None,
    params: Optional[Dict[str, Any]] = None,
    tokenizer=None,
    device: Optional[DeviceLike] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    **runner_kwargs,
) -> LVLMRunner:
    """``device=None`` is the card (``resolve_device``).  The weights come
    from ``params`` when given, else ``load_params`` on the path that
    ``paths`` (default: ``get_paths()``, the environment) names for the
    model.  ``runner_kwargs`` go to ``LVLMRunner`` (``quant=``,
    ``pad_multiple=``, ...)."""
    dev = resolve_device(device)
    paths = paths or get_paths()
    cfg = get_model_config(model_name)
    field = _MODEL_PATH_FIELD.get(model_name)
    path = getattr(paths, field, None) if field else None
    tokenizer = tokenizer or build_tokenizer(cfg, path)
    cfg = cfg.replace(
        image_token_id=tokenizer.image_token_id,
        pad_token_id=tokenizer.pad_token_id,
        bos_token_id=tokenizer.bos_token_id,
        eos_token_id=tokenizer.eos_token_id,
    )
    if model_name.startswith("tiny-") and tokenizer.vocab_size != cfg.text.vocab_size:
        cfg = cfg.replace(
            text=cfg.text.__class__(**{**cfg.text.__dict__, "vocab_size": tokenizer.vocab_size})
        )
    image_size = None
    if "idefics2" in model_name and ("seed" in dataset_name or "mme" in dataset_name):
        # seed/mme cannot run full resolution (reference src/utils.py:76-79)
        image_size = 448
    if params is None:
        params = load_params(cfg, path, dtype=dtype, seed=seed, device=dev)
    return LVLMRunner(cfg, params, tokenizer, device=dev, image_size=image_size, **runner_kwargs)
