"""Kimi-VL-A3B in the port against its plain reference
(``benchmark/reference/kimi_vl.py``), float32 on the CPU at tiny widths on
seeded random weights: MoonViT (2D RoPE, the interpolated position table,
the merge and the projector) image by image; the latent-attention tower with
routed experts through ``lvlm_forward``, with and without the MimIC shift;
the MimIC cell's first train steps (losses, the first gradient, AdamW's
change) through the benchmark's harness; beam-3 generation through
``LVLMRunner.generate`` against the reference's log-probabilities; the
attention path the tower takes; the processor's token expansion.  The
reference imports nothing of the port, and nothing here imports JAX.

    python -m pytest --noconftest tests/test_torch_kimi_vl.py -q
"""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import harness, program, registry, weights
from benchmark.reference import kimi_vl as fam
from benchmark.reference import mimic, plain
from mimic_tpu_torch.models import decoder as tdec
from mimic_tpu_torch.models import moonvit
from mimic_tpu_torch.models.config import get_model_config
from mimic_tpu_torch.models.lvlm import lvlm_forward

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CELL = "kimi-vl-a3b.mimic-train-8shot"
# tiny images: native sizes of 1-4 x 1-4 merged patches, one over the tiny
# in_token_limit of 64 patches (resized before its padding)
SIZES = [[30, 50], [60, 20], [28, 56], [140, 140], [41, 41]]


def tiny_cfg():
    """The configuration file's structure at the port's ``tiny-kimi-vl`` widths."""
    cfg = copy.deepcopy(json.loads((ROOT / "benchmark/configs/kimi-vl-a3b-instruct.json")
                                   .read_text()))
    cfg.update(name="tiny-kimi-vl", program_model="tiny-kimi-vl", vocab_size=264,
               hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, intermediate_size=128, kv_lora_rank=16,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
               num_experts_per_tok=3, moe_intermediate_size=32, n_shared_experts=1)
    cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, init_pos_emb_height=8,
                                init_pos_emb_width=8)
    cfg["processor"]["in_token_limit"] = 64
    return cfg


def tiny_train_cell():
    wl = copy.deepcopy(registry.workload(CELL))
    cfg = tiny_cfg()
    p = wl["params"]
    p.update(demos=2, demo_question_chars=[14, 18], demo_answer_chars=[1, 3],
             query_question_chars=[15, 16], answer_chars=[3, 2], pad_multiple=64,
             image_sizes=SIZES[:3], distinct_batches=4)
    rows = registry.traffic("mimic_train").raw_batches(cfg, p, 1)[0]
    c = mimic.collate(fam, cfg, fam.sizes(cfg), rows, p["pad_multiple"])
    p.update(record_len=c["f_ids"].shape[1], shift_len=c["q_ids"].shape[1])
    return wl, cfg


def build(seed=3):
    cfg = tiny_cfg()
    w = weights.make_weights(cfg, seed, CPU, torch.float32)
    return cfg, w, program.build(cfg, w, CPU, torch.float32)


def images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=tuple(hw) + (3,), dtype=np.uint8) for hw in SIZES]


def test_tiny_config_is_the_ports_preset():
    """The architecture check of the harness passes on the tiny preset, and
    the real configuration file's keys are the port's kimi-vl-a3b-instruct."""
    cfg, w, runner = build()
    real = json.loads((ROOT / "benchmark/configs/kimi-vl-a3b-instruct.json").read_text())
    pcfg = get_model_config("kimi-vl-a3b-instruct")
    program.check_architecture(pcfg, real)
    s = fam.sizes(real)
    assert fam.shift_shapes(s) == {"attn_v": (27, 16, 128), "attn_logz1_w": (27, 16, 192),
                                   "attn_logz1_b": (27, 16)}
    n = sum(int(np.prod(shape)) for _, shape, _ in fam.specs(real, s))
    assert abs(n / 1e9 - 16.4) < 0.1  # 15.96 B in the tower and the head, MoonViT ~0.44 B


@pytest.mark.parametrize("shape", SIZES + [[480, 640], [640, 427], [900, 1400]])
def test_processor_grid_and_tokens_follow_the_image(shape):
    """Patches after the in_token_limit resize and padding to 28 px; one
    token a merged patch; the port's processor and the reference agree."""
    real = json.loads((ROOT / "benchmark/configs/kimi-vl-a3b-instruct.json").read_text())
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer

    proc = moonvit.MoonViTProcessor(get_model_config("kimi-vl-a3b-instruct"), SimpleTokenizer())
    s = fam.sizes(real)
    img = np.zeros(tuple(shape) + (3,), np.uint8)
    gh, gw = proc.grid(img)
    assert gh * gw == fam.vit_rows(tuple(shape), real, s)
    assert proc.image_tokens(img) == fam.image_tokens(tuple(shape), real, s) == gh * gw // 4
    assert gh * gw <= 4096 + 2 * (gh + gw)  # the limit, and at most the padding's rows
    want = {(480, 640): (36, 46), (640, 427): (46, 32)}
    if tuple(shape) in want:
        assert (gh, gw) == want[tuple(shape)]


def test_moonvit_matches_the_reference_image_by_image():
    cfg, w, runner = build()
    s = fam.sizes(cfg)
    ims = images()
    enc = runner.processor([ims, ims[1:3]], ["a<image>b<image>c<image>d<image>e<image>",
                                             "x<image>y<image>"])
    got = moonvit.encode(runner.params, runner.cfg, torch.from_numpy(enc["pixel_values"]),
                         torch.from_numpy(enc["patch_mask"]))
    prec = plain.Precision("fp32")
    for b, row in enumerate([ims, ims[1:3]]):
        want = torch.cat([fam.encode_image(w, cfg, s, torch.from_numpy(
            fam.process_image(im, cfg, s)[0]), None, prec) for im in row])
        torch.testing.assert_close(got[b, : len(want)], want, rtol=1e-4, atol=1e-5)
        # pixels bit-equal to the reference's preprocessing
        px = fam.process_image(row[0], cfg, s)[0]
        p = s["patch"]
        gh, gw = px.shape[0] // p, px.shape[1] // p
        ref_patches = px.reshape(gh // 2, 2, p, gw // 2, 2, p, 3).transpose(0, 3, 1, 4, 2, 5, 6)
        np.testing.assert_array_equal(enc["pixel_values"][b, 0, : gh * gw],
                                      ref_patches.reshape(gh * gw, -1))


def test_position_interpolation_is_bicubic_interpolate():
    table = torch.randn(64 * 64, 5)
    for h, w in ((36, 46), (64, 64), (80, 20), (1, 3)):
        r, c = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        r, c = r.reshape(1, -1), c.reshape(1, -1)
        got = moonvit.interpolated_positions(table, r, c, torch.tensor([[h]]), torch.tensor([[w]]))
        want = torch.nn.functional.interpolate(
            table.reshape(64, 64, 5).permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
            align_corners=False)[0].permute(1, 2, 0).reshape(1, h * w, 5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_shift", [False, True])
def test_tower_matches_the_reference(with_shift):
    """Logits of every real row, and each layer's MLP output (the MimIC
    capture), the shift's gate on log Z2 over every key."""
    cfg, w, runner = build()
    s = fam.sizes(cfg)
    ims = images(1)
    texts = ["a question<image>answer", "<image><image> two images and some more text"]
    rows = [ims[:1], ims[2:4]]
    enc = runner.processor(rows, texts)
    batch = runner._to_batch(enc)
    g = torch.Generator().manual_seed(5)
    shift = None
    if with_shift:
        shift = {k: torch.randn(shape, generator=g) * 0.05
                 for k, shape in fam.shift_shapes(s).items()}
        shift["attn_logz1_b"] = torch.full(fam.shift_shapes(s)["attn_logz1_b"], 0.3)
    out = lvlm_forward(runner.params, runner.cfg, batch, shift=shift, capture_ffn=True)
    prec = plain.Precision("fp32")
    ids = torch.from_numpy(enc["input_ids"]).long()
    procd = [[(torch.from_numpy(fam.process_image(im, cfg, s)[0]), None) for im in r] for r in rows]
    emb = mimic._embed(fam, cfg, s, w, ids, procd, prec)
    h, caps = fam.decoder(w, s, cfg, emb, ids != plain.PAD, shift, None,
                          torch.arange(ids.shape[1])[None].expand(2, -1), prec)
    logits = prec.mm(h, w["lm"]["lm_head"])
    real = torch.from_numpy(enc["attention_mask"]).bool()
    torch.testing.assert_close(out.logits[real], logits[real], rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(out.decoder.ffn_capture[:, real], caps[:, real], rtol=1e-4,
                               atol=2e-5)


def test_mimic_train_steps_match_the_reference():
    """Three MimIC steps through the harness (the port's collator and
    ``make_train_step``) against the reference's: losses, the first gradient
    and the shift's change, each leaf (v 16 wide, log Z1 weight 24)."""
    wl, cfg = tiny_train_cell()
    r = harness.run_cell(wl, cfg, 2**31 + 7, 0.3, False, CPU, time.perf_counter(),
                         {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3},
                         dtype=torch.float32)
    assert r["correct"], r["checks"]


def test_beam_generation_scores_match_the_reference():
    """``LVLMRunner.generate`` at beam 3 through the harness's eval traffic, on
    unpadded prompts with a shift (latent attention through the cache, 192-wide
    keys and 128-wide values): each served sequence's score is the reference's
    log-probability of its tokens, and each token is in its parent's top 2 x 3."""
    wl = copy.deepcopy(registry.workload("idefics2-8b.vqa-eval-b32"))
    wl["params"].update(
        questions_per_call=4, pool_calls=3, question_chars=[20] * 4, pad_multiple=1,
        image_sizes=[[28, 56]] * 4, sample_questions=5, max_new_tokens=4,
        template="<|im_user|>user<|im_middle|>{instruction}<image>{q}<|im_end|>")
    r = harness.run_cell(wl, tiny_cfg(), 2**31 + 9, 0.3, False, CPU, time.perf_counter(),
                         {"score_gap": 1e-4, "token_rank": 5}, dtype=torch.float32)
    assert r["correct"], r["checks"]


def test_latent_attention_takes_the_kernels_on_the_card():
    """(192, 128) is a pair both kernel directions take: a cacheless pass on
    the card routes to "flash"; one the kernels cannot take raises, never
    "xla"; the dense towers keep their routes."""
    t = get_model_config("kimi-vl-a3b-instruct").text
    sel = tdec.select_attn_path
    for T in (768, 5376):
        assert sel(t, "flash", T, cacheless=True, has_key_mask=True, on_card=True) == "flash"
    with pytest.raises(ValueError, match="latent attention"):
        sel(t, "flash", 700, cacheless=True, has_key_mask=True, on_card=True)
    assert sel(t, "flash", 700, cacheless=True, has_key_mask=True) == "xla"  # the CPU
    assert sel(t, "flash", 1, cacheless=False, has_key_mask=True, on_card=True) == "cached"
    d128 = get_model_config("idefics2-8b-base").text
    assert sel(d128, "flash", 256, cacheless=True, has_key_mask=True, on_card=True) == "flash"
    assert sel(d128, "flash", 200, cacheless=True, has_key_mask=True, on_card=True) == "xla"


def test_latent_attention_and_experts_refuse_what_they_do_not_run():
    cfg, w, runner = build()
    batch = runner._to_batch(runner.processor(None, ["some text"]))
    with pytest.raises(ValueError, match="one rank"):
        lvlm_forward(runner.params, runner.cfg, batch, ring_mesh=object())
    with pytest.raises(ValueError, match="one rank"):
        lvlm_forward(runner.params, runner.cfg, batch, adapters={"q_a": torch.zeros(3, 2, 2)})


def test_kv_cache_holds_the_query_and_value_widths():
    t = get_model_config("tiny-kimi-vl").text
    c = tdec.init_kv_cache(t, 2, 16, CPU)
    assert c["k"].shape == (3, 2, 16, 4, 24) and c["v"].shape == (3, 2, 16, 4, 16)


@pytest.mark.parametrize("multi", [True, False], ids=["multi-head", "single-head"])
def test_shift_widths_follow_query_and_value_heads(multi):
    """log Z1's weight over the post-RoPE q (24 wide in the tiny tower, 192 in
    the real one), v over the attention output (16 / 128); flat over the heads
    without MULTI_HEAD.  The dense towers keep their shapes and draw order."""
    from mimic_tpu_torch.config import EncoderConfig
    from mimic_tpu_torch.shift.functional import apply_attn_shift
    from mimic_tpu_torch.shift.params import init_shift_params

    heads = " | ShiftStrategy.MULTI_HEAD" if multi else ""
    enc = EncoderConfig(attn_strategy="ShiftStrategy.VECTOR_SHIFT | "
                                      "ShiftStrategy.LEARNABLE_SHIFT_SCALE" + heads)
    for name, (dqk, dv) in (("tiny-kimi-vl", (24, 16)), ("kimi-vl-a3b-instruct", (192, 128))):
        t = get_model_config(name).text
        p = init_shift_params(enc, t, torch.Generator().manual_seed(0), CPU)
        L, H = t.num_layers, t.num_heads
        assert p["attn_v"].shape == ((L, H, dv) if multi else (L, H * dv))
        assert p["attn_logz1_w"].shape == ((L, H, dqk) if multi else (L, H * dqk))
    # the dense towers: v drawn first, then the weight, at (L, H, Dh) or (L, D)
    t = get_model_config("tiny-idefics2").text
    p = init_shift_params(enc, t, torch.Generator().manual_seed(1), CPU)
    g = torch.Generator().manual_seed(1)
    shape = (t.num_layers, t.num_heads, t.head_size) if multi else (t.num_layers, t.hidden_size)
    assert torch.equal(p["attn_v"], torch.randn(shape, generator=g) * 0.001)
    assert torch.equal(p["attn_logz1_w"], torch.randn(shape, generator=g) * 0.02)
    # the gate over 24-wide queries adds to 16-wide outputs, with and without log Z1
    tk = get_model_config("tiny-kimi-vl").text
    p = init_shift_params(enc, tk, torch.Generator().manual_seed(2), CPU)
    q, attn = torch.randn(2, 5, 4, 24), torch.randn(2, 5, 4, 16)
    lz2 = torch.randn(2, 5, 4)
    layer = {k: v[0] for k, v in p.items()}
    out = apply_attn_shift(layer, q, lz2, attn, multi)
    if multi:
        mu = torch.sigmoid(torch.einsum("bthd,hd->bth", q, layer["attn_logz1_w"])
                           + layer["attn_logz1_b"] - lz2)
        torch.testing.assert_close(out, attn + mu[..., None] * layer["attn_v"])
    else:
        mu = torch.sigmoid(q.reshape(2, 5, 96) @ layer["attn_logz1_w"] + layer["attn_logz1_b"]
                           - lz2.mean(-1))
        torch.testing.assert_close(out, (attn.reshape(2, 5, 64) + mu[..., None]
                                         * layer["attn_v"]).reshape(attn.shape))
    v_only = {"attn_v": layer["attn_v"]}
    torch.testing.assert_close(apply_attn_shift(v_only, q, lz2, attn, multi),
                               attn + layer["attn_v"].reshape(attn.shape[2:]))
