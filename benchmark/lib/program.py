"""The system under test: ``mimic_tpu_torch`` (imported only here and in the
traffic files, never by the reference).

``build`` hands the benchmark's weights to the port's ``build_model`` and
checks that the port's architecture for the model is the configuration
file's, so that the program and the reference run the same model.
"""

from __future__ import annotations

from typing import Any, Dict

from .weights import sizes


def _expect(cfg: Dict[str, Any]) -> Dict[str, Any]:
    s = sizes(cfg)
    t, v = cfg["text_config"], cfg["vision_config"]
    want = {
        "text.vocab_size": s["V"], "text.hidden_size": s["D"], "text.num_layers": s["L"],
        "text.num_heads": s["H"], "text.num_kv_heads": s["Hkv"],
        "text.intermediate_size": s["F"], "text.head_size": s["Dh"],
        "text.norm_eps": t["rms_norm_eps"], "text.rope_theta": t["rope_theta"],
        "text.attn_bias": cfg["family"] == "llava_interleave",
        "text.sliding_window": None,
        "vision.hidden_size": s["Dv"], "vision.num_layers": s["Lv"],
        "vision.num_heads": s["Hv"], "vision.intermediate_size": s["Fv"],
        "vision.image_size": s["image"], "vision.patch_size": s["patch"],
        "vision.norm_eps": v["layer_norm_eps"], "vision.use_class_token": False,
        "vision.post_layernorm": cfg["family"] == "idefics2",
        "image_seq_len": s["image_tokens"],
    }
    if cfg["family"] == "idefics2":
        want.update({"perceiver.num_latents": s["latents"], "perceiver.num_layers": s["Lp"],
                     "perceiver.num_heads": s["Hp"], "perceiver.num_kv_heads": s["Hkvp"],
                     "perceiver.head_dim": s["Dhp"]})
    return want


def check_architecture(pcfg, cfg: Dict[str, Any]) -> None:
    """Raise unless the port's ``ModelConfig`` is the configuration file's."""
    diffs = []
    for key, want in _expect(cfg).items():
        node = pcfg
        for part in key.split("."):
            node = getattr(node, part)
        # the port's perceiver leaves these unset where they take their defaults
        if key == "perceiver.num_kv_heads" and node is None:
            node = pcfg.perceiver.num_heads
        if key == "perceiver.head_dim" and node is None:
            node = pcfg.text.hidden_size // pcfg.perceiver.num_heads
        if node != want:
            diffs.append(f"{key}: program {node!r}, configuration {want!r}")
    if diffs:
        raise ValueError("the program's architecture differs from the configuration: "
                         + "; ".join(diffs))


def build(cfg: Dict[str, Any], weights, device, dtype, **runner_kwargs):
    """The port's runner for the configuration, on the benchmark's weights."""
    from mimic_tpu_torch.models.factory import build_model, check_params

    runner = build_model(cfg["program_model"], params=weights, device=device, dtype=dtype,
                         **runner_kwargs)
    check_architecture(runner.cfg, cfg)
    check_params(weights, runner.cfg)
    return runner
