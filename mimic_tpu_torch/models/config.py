"""Model architecture configs for the three LVLM families.

The reference wraps HF implementations (``testbed/models/idefics.py``, ``idefics2.py``,
``llava.py``); here each architecture is described by plain dataclasses consumed by the
functional decoder/vision modules:

- **idefics-9b**: LLaMA-style text tower + gated cross-attention to a CLIP-ViT →
  perceiver-resampler vision path, with qk-layernorm in self/cross attention.
- **idefics2-8b**: Mistral text tower (GQA, sliding window off) + SigLIP ViT →
  perceiver connector producing 64 inline image tokens.
- **llava-interleave-7b**: Qwen2 text tower (GQA + qkv bias) + SigLIP ViT →
  2-layer MLP projector producing one inline token per patch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    qk_layernorm: bool = False      # per-head RMS norms in self-attention
    cross_qk_layernorm: bool = False  # idefics-9b gated cross-attention
    attn_bias: bool = False         # qwen2 uses bias on q/k/v projections
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None
    # gated cross-attention every k-th layer (idefics-9b); None = none
    cross_attn_interval: Optional[int] = None
    # width of the cross-attention key/value inputs (perceiver output dim)
    cross_kv_dim: Optional[int] = None
    # multi-head latent attention (DeepSeek-V3's, Kimi-VL's; on when kv_lora_rank
    # is set): q heads of qk_nope + qk_rope, one shared rope key, k_nope and v
    # from an RMS-normed latent of kv_lora_rank
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # routed experts (on when n_routed_experts is set) in the layers from
    # first_k_dense_replace on: sigmoid scores, the top num_experts_per_tok by
    # score plus a correction bias, their scores normalised and scaled by
    # routed_scaling_factor, and n_shared_experts experts' width on every token
    n_routed_experts: Optional[int] = None
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0

    @property
    def qk_head_size(self) -> int:
        mla = self.kv_lora_rank is not None
        return self.qk_nope_head_dim + self.qk_rope_head_dim if mla else self.head_size

    @property
    def v_head_size(self) -> int:
        return self.v_head_dim if self.kv_lora_rank is not None else self.head_size

    @property
    def num_moe_layers(self) -> int:
        if self.n_routed_experts is None:
            return 0
        return self.num_layers - self.first_k_dense_replace

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def num_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_cross_layers(self) -> int:
        if self.cross_attn_interval is None:
            return 0
        return self.num_layers // self.cross_attn_interval


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    image_size: int
    patch_size: int
    norm_eps: float = 1e-6
    use_class_token: bool = False    # CLIP yes, SigLIP no
    hidden_act: str = "gelu_tanh"    # SigLIP "gelu_tanh", CLIP "quick_gelu"
    # llava takes vision_feature_layer=-2: features leave the tower before the
    # final norm, so the post-layernorm is skipped entirely
    post_layernorm: bool = True
    # MoonViT (Kimi-VL): each image at its own resolution (image_size / patch_size
    # is the side of the position table, interpolated to each image's patch grid),
    # at most in_token_limit patches an image, 2D RoPE (rope_theta) on q and k, and
    # merge_kernel x merge_kernel patches merged into one token
    in_token_limit: int = 0
    merge_kernel: int = 1
    rope_theta: float = 10000.0

    @property
    def num_patches(self) -> int:
        n = (self.image_size // self.patch_size) ** 2
        return n + (1 if self.use_class_token else 0)


@dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler (idefics1) / connector (idefics2).

    ``style="idefics2"``: RMSNorm + gated-SiLU MLP + GQA (Idefics2PerceiverResampler).
    ``style="idefics1"``: LayerNorm(+bias) + ReLU MLP + optional per-head
    qk-layernorms (IdeficsPerceiverResampler).
    """

    num_latents: int = 64
    num_layers: int = 3
    num_heads: int = 16
    num_kv_heads: Optional[int] = None  # idefics2 connector uses GQA in the perceiver
    head_dim: Optional[int] = None
    intermediate_size: Optional[int] = None
    style: str = "idefics2"
    qk_layernorm: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # "idefics1" | "idefics2" | "llava-interleave"
    text: TextConfig
    vision: Optional[VisionConfig] = None
    perceiver: Optional[PerceiverConfig] = None
    # token ids filled by the tokenizer/processor at load time
    image_token_id: int = -1
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    # how many text-sequence positions one image occupies (inline families)
    image_seq_len: int = 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# real architectures (dimensions from the published HF configs)
# ---------------------------------------------------------------------------


def idefics_9b() -> ModelConfig:
    return ModelConfig(
        name="idefics-9b",
        family="idefics1",
        text=TextConfig(
            vocab_size=32016,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            intermediate_size=11008,
            norm_eps=1e-6,
            # HF IdeficsDecoderLayer self-attention has NO qk-layernorms even when
            # config.qk_layer_norms is set; only the gated cross-attention does
            qk_layernorm=False,
            cross_qk_layernorm=True,
            cross_attn_interval=4,
            cross_kv_dim=1280,
            max_position_embeddings=2048,
        ),
        vision=VisionConfig(
            hidden_size=1280,
            num_layers=32,
            num_heads=16,
            intermediate_size=5120,
            image_size=224,
            patch_size=14,
            use_class_token=True,
            hidden_act="quick_gelu",
            norm_eps=1e-5,
        ),
        perceiver=PerceiverConfig(
            num_latents=64, num_layers=6, num_heads=16, style="idefics1",
            qk_layernorm=True,
        ),
        image_seq_len=0,  # idefics1 feeds vision via cross-attention, not inline tokens
    )


def idefics2_8b_base() -> ModelConfig:
    return ModelConfig(
        name="idefics2-8b-base",
        family="idefics2",
        text=TextConfig(
            vocab_size=32003,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            intermediate_size=14336,
            norm_eps=1e-5,
            rope_theta=10000.0,
            max_position_embeddings=32768,
        ),
        vision=VisionConfig(
            hidden_size=1152,
            num_layers=27,
            num_heads=16,
            intermediate_size=4304,
            image_size=980,
            patch_size=14,
            use_class_token=False,
            hidden_act="gelu_tanh",
        ),
        perceiver=PerceiverConfig(
            num_latents=64, num_layers=3, num_heads=16, num_kv_heads=4, head_dim=96,
            intermediate_size=14336,
        ),
        image_seq_len=64,
    )


def llava_interleave_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-interleave-7b",
        family="llava-interleave",
        text=TextConfig(
            vocab_size=152128,
            hidden_size=3584,
            num_layers=28,
            num_heads=28,
            num_kv_heads=4,
            intermediate_size=18944,
            norm_eps=1e-6,
            rope_theta=1000000.0,
            attn_bias=True,
            max_position_embeddings=32768,
        ),
        vision=VisionConfig(
            hidden_size=1152,
            num_layers=26,  # vision_feature_layer=-2 drops the last block
            num_heads=16,
            intermediate_size=4304,
            image_size=384,
            patch_size=14,
            use_class_token=False,
            hidden_act="gelu_tanh",
            post_layernorm=False,
        ),
        image_seq_len=(384 // 14) ** 2,  # 729 tokens per image
    )


# ---------------------------------------------------------------------------
# tiny configs for tests / compile checks (same structure, small dims)
# ---------------------------------------------------------------------------


def tiny_text(family: str = "idefics2", **kw) -> ModelConfig:
    base = dict(
        vocab_size=256,
        hidden_size=64,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        intermediate_size=128,
    )
    if family == "idefics1":
        base.update(num_kv_heads=4, cross_qk_layernorm=True, cross_attn_interval=2, cross_kv_dim=32)
    elif family == "llava-interleave":
        base.update(attn_bias=True)
    base.update(kw)
    if family == "kimi-vl":
        return tiny_kimi_vl(**kw)
    if family == "text":
        # text-only tower (reference mistral/qwen2 testbed wrapper surface)
        return ModelConfig(
            name="tiny-text", family="text", text=TextConfig(**base),
            image_token_id=250, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        )
    vision = VisionConfig(
        hidden_size=32,
        num_layers=2,
        num_heads=2,
        intermediate_size=64,
        image_size=28,
        patch_size=14,
        use_class_token=(family == "idefics1"),
        post_layernorm=(family != "llava-interleave"),
    )
    perceiver = (
        PerceiverConfig(
            num_latents=4, num_layers=2, num_heads=2,
            style="idefics1" if family == "idefics1" else "idefics2",
            qk_layernorm=family == "idefics1",
        )
        if family in ("idefics1", "idefics2")
        else None
    )
    image_seq_len = {"idefics1": 0, "idefics2": 4, "llava-interleave": 4}[family]
    return ModelConfig(
        name=f"tiny-{family}",
        family=family,
        text=TextConfig(**base),
        vision=vision,
        perceiver=perceiver,
        image_token_id=250,
        pad_token_id=0,
        bos_token_id=1,
        eos_token_id=2,
        image_seq_len=image_seq_len,
    )


def llava_15_7b() -> ModelConfig:
    """LLaVA-1.5 (LLaMA-7B text + CLIP-ViT-L/336, MLP projector).

    The reference's testbed supports llava-1.5 wrappers (testbed/models/llava.py
    HF_LLAVA["llava-1.5"]) even though its pipeline only drives llava-interleave.
    """
    return ModelConfig(
        name="llava-1.5-7b",
        family="llava-interleave",  # same inline-token architecture; template differs
        text=TextConfig(
            vocab_size=32064,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=32,
            intermediate_size=11008,
            norm_eps=1e-5,
            max_position_embeddings=4096,
        ),
        vision=VisionConfig(
            hidden_size=1024,
            num_layers=23,  # vision_feature_layer=-2
            num_heads=16,
            intermediate_size=4096,
            image_size=336,
            patch_size=14,
            use_class_token=True,
            hidden_act="quick_gelu",
            norm_eps=1e-5,
            post_layernorm=False,
        ),
        image_seq_len=(336 // 14) ** 2,
    )


def mistral_7b() -> ModelConfig:
    """Text-only Mistral tower (reference testbed/models/mistral.py surface)."""
    return ModelConfig(
        name="mistral-7b",
        family="text",
        text=TextConfig(
            vocab_size=32000,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            intermediate_size=14336,
            norm_eps=1e-5,
            sliding_window=4096,
            max_position_embeddings=32768,
        ),
    )


def qwen2_7b() -> ModelConfig:
    """Text-only Qwen2 tower (reference testbed/models/qwen2.py surface)."""
    return ModelConfig(
        name="qwen2-7b",
        family="text",
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            num_layers=28,
            num_heads=28,
            num_kv_heads=4,
            intermediate_size=18944,
            norm_eps=1e-6,
            rope_theta=1000000.0,
            attn_bias=True,
            max_position_embeddings=32768,
        ),
    )


def kimi_vl_a3b_instruct() -> ModelConfig:
    """Kimi-VL-A3B-Instruct: a DeepSeek-V3-style tower (MLA without a q LoRA,
    64 routed experts and 2 shared ones from layer 1 on) and MoonViT at native
    resolution with a 2 x 2 patch merge and an MLP projector."""
    return ModelConfig(
        name="kimi-vl-a3b-instruct",
        family="kimi-vl",
        text=TextConfig(
            vocab_size=163840,
            hidden_size=2048,
            num_layers=27,
            num_heads=16,
            num_kv_heads=16,
            intermediate_size=11264,
            norm_eps=1e-5,
            rope_theta=800000.0,
            max_position_embeddings=131072,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            n_routed_experts=64,
            num_experts_per_tok=6,
            moe_intermediate_size=1408,
            n_shared_experts=2,
            first_k_dense_replace=1,
            routed_scaling_factor=2.446,
        ),
        vision=VisionConfig(
            hidden_size=1152,
            num_layers=27,
            num_heads=16,
            intermediate_size=4304,
            image_size=64 * 14,  # the 64 x 64 position table
            patch_size=14,
            norm_eps=1e-5,
            hidden_act="gelu_tanh",
            in_token_limit=4096,
            merge_kernel=2,
        ),
    )


def tiny_kimi_vl(**kw) -> ModelConfig:
    """``kimi_vl_a3b_instruct``'s structure at test widths: q/k heads 24 wide,
    v heads 16, 8 experts (3 a token), an 8 x 8 position table."""
    text = dict(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=4,
        intermediate_size=128, rope_theta=800000.0, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,
        moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1,
        routed_scaling_factor=2.446,
    )
    text.update(kw)
    return ModelConfig(
        name="tiny-kimi-vl",
        family="kimi-vl",
        text=TextConfig(**text),
        vision=VisionConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            image_size=8 * 14, patch_size=14, norm_eps=1e-5, in_token_limit=64,
            merge_kernel=2,
        ),
        image_token_id=250, pad_token_id=0, bos_token_id=1, eos_token_id=2,
    )


MODEL_CONFIGS = {
    "idefics-9b": idefics_9b,
    "idefics2-8b-base": idefics2_8b_base,
    "llava-interleave-7b": llava_interleave_7b,
    "llava-1.5-7b": llava_15_7b,
    "mistral-7b": mistral_7b,
    "qwen2-7b": qwen2_7b,
    "kimi-vl-a3b-instruct": kimi_vl_a3b_instruct,
}


def get_model_config(name: str) -> ModelConfig:
    if name.startswith("tiny-"):
        return tiny_text(name[len("tiny-"):])
    try:
        return MODEL_CONFIGS[name]()
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; valid: {', '.join(MODEL_CONFIGS)} or tiny-<family>"
        ) from None
