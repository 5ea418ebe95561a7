#!/usr/bin/env python3
"""Drive mimic_tpu_torch's serving and training paths once on one CUDA card and check them.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure propagates: non-zero exit, no result line):

1. build   — compile the CUDA kernels (mimic_tpu_torch/ops/csrc/*.cu) with nvcc
             for sm_90a, one nvcc per source started together; print the build
             time and the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card, bf16,
             at the shapes its path gives it: the forward kernels at the
             serving shapes (ViT rows, eval-protocol prefill, long prefill, a
             ragged key axis); the backward pair at the shift pass (B2 T=S=256,
             left-padded, lse_u), B1 T=S=2048, a ragged B2 T=S=1000, and
             without need_unmasked; max error against stated tolerances, and
             both times from CUDA events.
3. slice   — a tiny idefics2 in fp32 (ViT head dim 72, text head dim 128): the
             serving path through the kernels on the card must give the beam-3
             tokens of the plain path on the CPU, and prefill logits within 1e-4;
             then 3 MimIC train steps (make_train_step) through the kernels on
             the card against 3 through the plain path on the CPU: per-step
             metrics and the final shift tree within 1e-4.
4. main    — build_model("idefics2-8b-base") at full width and depth with random
             bf16 parameters made on the card, a MimIC shift (logz2="unmasked"),
             runner.generate with beam 3 and 10 new tokens: call A, 4 requests
             with one 980 px image each, bucketed to a 512-token prompt; call B,
             2 requests with a long context, bucketed to 4096 tokens so the
             prefill takes flash_fwd.  One warm-up of each call, then the counted
             and timed run.  Both kernels must have launched in that run, every
             prefill must have taken the "flash" path, and the 8B prefill logits
             through the kernels must match the plain attention path's.  Then
             one more run of each call under torch.profiler prints the device
             time by kernel group and the top kernels.
5. train   — the MimIC dual-pass train step on the same 8B runner: the mimic
             preset's shift in fp32 (logz2="unmasked"), build_optimizer at lr
             5e-3, make_train_step with attn_impl="flash"; a batch shaped like
             scripts/bench_8b_train.py (B2, record pass 2048 tokens with 8 demo
             images + the query image at 980 px, shift pass 256 tokens with the
             query image, 64 gathered query tokens per row).  One warm-up step,
             then 3 counted and timed steps: every decoder call took "flash",
             both backward kernels launched L - 1 = 31 times per step (layer
             0's attention inputs carry no gradient), the forward kernel
             launched, loss and grad_norm finite and grad_norm > 0, frozen
             weights bit-unchanged, shift changed.  Then one step under
             torch.profiler, the per-leaf gradients of one step through the
             kernels against the plain attention path (cosine >= 0.99), and the
             step timed again on precomputed image features (what a training
             vision-feature cache would leave of it), once under the profiler.
6. int8 kernels — int8_matmul, fused_mlp_int8 and prompt_attn_int8 against their
             plain versions on the card, bf16, at the decode shapes of the int8
             serving path (phase 2's rules: max error against stated tolerances,
             both times from CUDA events).
7. tiny int8 — phase 3's tiny idefics2 (text width 128) with quant="int8" and a
             MimIC shift: beam-3 tokens on the card identical to the CPU's,
             prefill and first-decode-step logits within 1e-4, exact int8 kernel
             launch counts, and the int8 trees quantized on the card bit-identical
             to the CPU's; then one decoder_forward decode step over an int8
             prompt cache, card (kernels) against CPU (plain versions), 1e-4.
8. 8B int8 — after phase 5, on the same runner: set_quant("int8"), calls A and B
             with the shift (exact launch counts, q/s), the first decode step's
             logits through the kernels against a bf16 tree dequantized from the
             same int8 handles (row cosine >= 0.99), one int8 call A under the
             profiler; call B without a shift, which takes the int8 prompt KV,
             timed against the same call with quant_kv=False; then
             set_quant("int8-memory"): call A, peak device memory, kernels in the
             prefill (lm head) and the decode steps.

The next-to-last line is {"kernels": [...]}, the last {"ok": true, "device": ...}.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MAX_NEW_TOKENS = 10
NUM_BEAMS = 3
# bf16 tolerances of a kernel against its plain version (same bf16 inputs):
# out may differ by a rounding step of the bf16 output (|out| < 4); lse and
# lse_u are fp32 from identical inputs, differing in summation order only
TOL_OUT_BF16 = 3e-2
TOL_LSE_BF16 = 2e-3
TOL_TINY_FP32 = 1e-4
MIN_LOGIT_COSINE = 0.99
# backward kernels against their plain version (same bf16 inputs, same saved
# forward): dq/dk/dv are fp32 sums rounded once to bf16 (2^-8 = 3.9e-3 of the
# value) and summed in another order; error relative to max |reference|
TOL_BWD_BF16 = 1e-2
MIN_GRAD_COSINE = 0.99
TRAIN_STEPS = 3
# int8 kernels against their plain versions (same bf16 inputs): matmul, MLP,
# and prompt-attention o and l within 1e-2 of max |reference| (one bf16
# rounding of an fp32 sum, plus the MLP's bf16 intermediate and the rounded
# p·vscale); the prompt attention's m (fp32 from identical scores) 1e-3 absolute
TOL_INT8_REL = 1e-2
TOL_INT8_M = 1e-3

KERNEL_META = {
    "flash_fwd": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mimic_tpu/ops/flash_attention.py:52",
    },
    "onepass_fwd": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/onepass_fwd.cu",
        "replaces": "mimic_tpu/ops/flash_attention.py:316",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "mimic_tpu/ops/flash_backward.py:70",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "mimic_tpu/ops/flash_backward.py:109",
    },
    # one kernel for both Pallas matmuls: a stacked layer is a pointer offset
    "int8_matmul": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mimic_tpu/ops/quant.py:232",
        "also_replaces": ["mimic_tpu/ops/quant.py:299"],
    },
    "fused_mlp_int8": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/fused_mlp_int8.cu",
        "replaces": "mimic_tpu/ops/quant.py:511",
    },
    "prompt_attn_int8": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/prompt_attn_int8.cu",
        "replaces": "mimic_tpu/ops/decode_attention.py:87",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q, k, v = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
        for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    )
    return q, k, v, torch.from_numpy(key_mask).to(dev)


def check_kernel(label, name, seed, B, T, S, H, Hkv, D, key_mask, causal, need_unmasked, reps):
    from mimic_tpu_torch.ops import flash_attention as tfa

    q, k, v, km = kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask)
    got = tfa._launch(name, q, k, v, km, causal, None, need_unmasked)
    torch.cuda.synchronize()
    want = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    torch.cuda.synchronize()
    allowed = km[:, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None]
    valid = allowed.any(-1).expand(B, T)  # rows with an attendable key
    # onepass_fwd, and flash_fwd with need_unmasked, visit every key: all rows agree
    every_key = name == "onepass_fwd" or need_unmasked
    errs = {}
    for field, a, b, rows, tol in (
        ("out", got[0], want[0], None if every_key else valid, TOL_OUT_BF16),
        ("lse", got[1], want[1], valid, TOL_LSE_BF16),
        ("lse_u", got[2], want[2], None if need_unmasked else valid, TOL_LSE_BF16),
    ):
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{label}: {field} has non-finite values")
        d = (a.float() - b.float()).abs()
        errs[field] = (d if rows is None else d[rows]).max().item()
        if errs[field] > tol:
            raise AssertionError(f"{label}: {field} max abs err {errs[field]} > {tol}")
    del want
    ms = cuda_ms(lambda: tfa._launch(name, q, k, v, km, causal, None, need_unmasked), reps)
    plain_ms = cuda_ms(
        lambda: tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked), reps
    )
    log(f"[kernels] {label}: {name} B{B} T{T} S{S} H{H}/{Hkv} D{D} causal={causal} "
        f"need_unmasked={need_unmasked}: max abs err out {errs['out']:.3e} "
        f"lse {errs['lse']:.3e} lse_u {errs['lse_u']:.3e} "
        f"(tol {TOL_OUT_BF16}/{TOL_LSE_BF16}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": name, "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms}


def left_padded_mask(B, S, pads):
    km = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        km[b, :p] = 0
    return km


def phase_kernels():
    # ViT rows of a 980 px image at a 980×742 aspect: a 70×53 valid patch grid
    # (interior zeros at every row end) inside 70×70 = 4900 patches, padded to 4992
    grid = np.zeros((70, 70), np.int32)
    grid[:, :53] = 1
    vit_mask = np.zeros((1, 4992), np.int32)
    vit_mask[0, :4900] = grid.reshape(-1)
    results = [
        check_kernel("vit", "onepass_fwd", 0, 1, 4992, 4992, 16, 16, 72, vit_mask,
                     causal=False, need_unmasked=False, reps=5),
        check_kernel("prefill-512", "onepass_fwd", 1, 4, 512, 512, 32, 8, 128,
                     left_padded_mask(4, 512, [0, 37, 120, 300]),
                     causal=True, need_unmasked=True, reps=10),
        check_kernel("prefill-4096", "flash_fwd", 2, 1, 4096, 4096, 32, 8, 128,
                     left_padded_mask(1, 4096, [250]),
                     causal=True, need_unmasked=True, reps=3),
        check_kernel("ragged-1000", "flash_fwd", 3, 2, 1000, 1000, 32, 8, 128,
                     left_padded_mask(2, 1000, [0, 77]),
                     causal=True, need_unmasked=True, reps=10),
        check_kernel("ragged-1000-vit", "flash_fwd", 4, 2, 1000, 1000, 16, 16, 72,
                     left_padded_mask(2, 1000, [0, 0]) * (np.arange(1000) < 930),
                     causal=False, need_unmasked=False, reps=10),
    ]
    # per kernel: the worst error over its shapes, the times at its main-path shape
    summary = {}
    for r, main_shape in zip(results, (True, False, True, False, False)):
        s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
        if main_shape:
            s["ms"], s["plain_ms"] = r["ms"], r["plain_ms"]
    return summary


def check_backward(label, seed, B, T, S, H, Hkv, key_mask, causal, need_unmasked, reps):
    """Both backward kernels against the plain backward on the same bf16
    inputs and the same saved forward (from the plain forward)."""
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb

    q, k, v, km = kernel_inputs(seed, B, T, S, H, Hkv, 128, key_mask)
    out, lse, lse_u = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    g_lse, g_lse_u = (torch.randn(B, T, H, generator=gen, device="cuda") for _ in range(2))
    args = (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, None, need_unmasked)
    got = tfb._launch_backward(*args)
    torch.cuda.synchronize()
    want = tfb.flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for field, a, b in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{label}: {field} has non-finite values")
        ref = b.float().abs().max().item()
        errs[field] = (a.float() - b.float()).abs().max().item() / ref
        if errs[field] > TOL_BWD_BF16:
            raise AssertionError(f"{label}: {field} max err {errs[field]:.3e} of max |ref| "
                                 f"{ref:.3e} > {TOL_BWD_BF16}")
    del got, want
    ms = {name: cuda_ms(lambda n=name: tfb._launch_backward(*args, kernels=(n,)), reps)
          for name in tfb.KERNELS}
    plain_ms = cuda_ms(lambda: tfb.flash_attention_backward_plain(*args), reps)
    log(f"[kernels] {label}: backward B{B} T{T} S{S} H{H}/{Hkv} D128 causal={causal} "
        f"need_unmasked={need_unmasked}: max err / max |ref| dq {errs['dq']:.3e} "
        f"dk {errs['dk']:.3e} dv {errs['dv']:.3e} (tol {TOL_BWD_BF16}: one bf16 rounding "
        f"of an fp32 sum); flash_bwd_dq {ms['flash_bwd_dq']:.3f} ms, flash_bwd_dkv "
        f"{ms['flash_bwd_dkv']:.3f} ms, plain backward (dq, dk, dv) {plain_ms:.3f} ms")
    return [
        {"name": "flash_bwd_dq", "max_abs_err": errs["dq"], "ms": ms["flash_bwd_dq"],
         "plain_ms": plain_ms},
        {"name": "flash_bwd_dkv", "max_abs_err": max(errs["dk"], errs["dv"]),
         "ms": ms["flash_bwd_dkv"], "plain_ms": plain_ms},
    ]


def phase_backward_kernels():
    """The backward pair at (a) the shift pass, (b) B1 T=S=2048 (where the JAX
    package would have taken its Pallas backward), (c) a ragged B2 T=S=1000,
    (d) without need_unmasked.  Errors are relative to max |reference|; the
    times reported for the kernels are the shift pass's."""
    cases = [
        ("bwd-shift-256", 10, 2, 256, 256, 32, 8, left_padded_mask(2, 256, [0, 61]), True, True, 10),
        ("bwd-2048", 11, 1, 2048, 2048, 32, 8, left_padded_mask(1, 2048, [0]), True, True, 3),
        ("bwd-ragged-1000", 12, 2, 1000, 1000, 32, 8, left_padded_mask(2, 1000, [0, 77]),
         True, True, 5),
        ("bwd-no-lse_u", 13, 2, 512, 512, 32, 8, left_padded_mask(2, 512, [0, 100]), True, False, 5),
    ]
    summary = {}
    for i, case in enumerate(cases):
        for r in check_backward(*case):
            s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
            if i == 0:
                s["ms"], s["plain_ms"] = r["ms"], r["plain_ms"]
    return summary


# ---------------------------------------------------------------------------
# phase 3: tiny fp32 slice, kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def tiny_cfg(tk, **text_kw):
    """tiny idefics2 with text head dim 128 (the flash path's) and a 70 px
    SigLIP with head dim 72 (the ViT's); ``text_kw`` overrides the text tower."""
    import dataclasses

    from mimic_tpu_torch.shared import tiny_text

    cfg = tiny_text("idefics2", head_dim=128, **text_kw)
    return cfg.replace(
        text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size),
        vision=dataclasses.replace(cfg.vision, hidden_size=144, num_heads=2, image_size=70),
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )


def phase_tiny_reference():
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from mimic_tpu_torch.shared import SimpleTokenizer, get_preset
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_cfg(tk)
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1), cpu)
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    rng = np.random.default_rng(5)
    # 70 px images need no resize, so the processor stays on numpy
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8)] for _ in range(2)]
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    runners = {}
    for dev in ("cpu", "cuda"):
        r = LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev)
        r.set_shift(shift)
        runners[dev] = r
    reset_launch_counts()
    logits, tokens = {}, {}
    for dev, r in runners.items():
        batch = r.process_input(images, texts, pad_to=128)
        T = batch.input_ids.shape[1]
        attn_impl = "flash" if dev == "cuda" else "xla"
        logits[dev], _, _ = tg._prefill(r.params, cfg, batch, T + 6, r.shift, "unmasked",
                                        torch.float32, attn_impl)
        tokens[dev] = tg.beam_generate(
            r.params, cfg, batch, max_new_tokens=6, num_beams=NUM_BEAMS,
            eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id, shift=r.shift,
            logz2="unmasked", attn_impl=attn_impl,
        ).tokens.cpu()
    torch.cuda.synchronize()
    # every tiny attention row is short: only the full-row kernel serves them
    if LAUNCHES["onepass_fwd"] == 0:
        raise AssertionError(f"tiny slice on the card did not launch onepass_fwd: {LAUNCHES}")
    got, want = logits["cuda"].cpu(), logits["cpu"]
    err = (got - want).abs().max().item()
    close = torch.allclose(got, want, rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
    same = torch.equal(tokens["cuda"], tokens["cpu"])
    log(f"[tiny] fp32 prefill last logits, kernels on the card vs plain on the CPU: "
        f"max abs err {err:.3e} of max |logit| {want.abs().max().item():.3f} "
        f"(rtol = atol = {TOL_TINY_FP32}: {close}); beam-3 tokens identical: {same}; "
        f"tokens {tokens['cuda'].tolist()}")
    if not close or not same:
        raise AssertionError("tiny slice: the kernel path disagrees with the plain path")


def phase_tiny_train():
    """3 MimIC steps through the kernels on the card against 3 through the
    plain attention path on the CPU, fp32, same parameters and batch."""
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shared import LVLMProcessor, SimpleTokenizer, TrainCollator, get_preset
    from mimic_tpu_torch.shift.params import init_shift_params
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    tk = SimpleTokenizer(padding_side="right")
    cfg = tiny_cfg(tk)
    enc, peft = get_preset("mimic")
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(enc, cfg.text, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(6)
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8) for _ in range(2)]
              for _ in range(2)]
    # the flash path needs 128-aligned sequences: the collator's default pads to 64
    collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), pad_multiple=128)
    tb = collator({
        "prefix_texts": ["Image:<image> Question: what is this? Answer: a cat\n",
                         "Image:<image> Question: how many? Answer: two\n"],
        "query_texts": ["Image:<image> Question: what now? Answer:",
                        "Image:<image> Question: who is it? Answer:"],
        "answers": ["a dog", "three"],
        "images": images,
    })
    history, final = {}, {}
    tfb.reset_launch_counts()
    for attn_impl, dev in (("flash", "cuda"), ("xla", "cpu")):
        tree = {"shift": {k: v.to(dev) for k, v in shift.items()}}
        frozen = _to(params, dev)
        tx = build_optimizer(tree, lr=peft.lr, weight_decay=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip=1.0)
        step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                                  align_loss_weight=peft.align_loss_weight, attn_impl=attn_impl)
        state = ts.TrainState(tree, tx.init(tree), 0)
        batch = ts.to_device_batch(tb, dev)
        rows = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, frozen, batch)
            rows.append({k: float(m[k]) for k in ("loss", "ce_loss", "ffn_mse_loss", "grad_norm")})
        history[attn_impl] = rows
        final[attn_impl] = {k: v.detach().cpu() for k, v in state.trainable["shift"].items()}
    launches = dict(tfb.LAUNCHES)
    per_step = cfg.text.num_layers - 1
    if launches != {"flash_bwd_dq": per_step * TRAIN_STEPS, "flash_bwd_dkv": per_step * TRAIN_STEPS}:
        raise AssertionError(f"tiny train on the card: backward launches {launches}")
    worst = 0.0
    for got, want in zip(history["flash"], history["xla"]):
        for k in want:
            worst = max(worst, abs(got[k] - want[k]) / max(abs(want[k]), 1e-12))
    tree_err = max((final["flash"][k] - v).norm().item() / v.norm().item()
                   for k, v in final["xla"].items())
    log(f"[tiny-train] fp32, kernels on the card vs plain attention on the CPU, "
        f"{TRAIN_STEPS} steps: per-step metrics {history['flash']}; worst relative diff "
        f"{worst:.3e}; final shift tree |diff|/|ref| {tree_err:.3e} (tol {TOL_TINY_FP32}); "
        f"backward launches {launches}")
    if worst > TOL_TINY_FP32 or tree_err > TOL_TINY_FP32:
        raise AssertionError("tiny train: the kernel path disagrees with the plain path")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 4: idefics2-8b-base at full width and depth
# ---------------------------------------------------------------------------


def synthetic_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(980, 980, 3), dtype=np.uint8)


WORDS = ("red blue green small large dog cat bus tree sky table person two three "
         "standing sitting water street kitchen field plate window").split()


def synthetic_text(seed: int, n_chars: int) -> str:
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n_chars:
        w = " ".join(rng.choice(WORDS, size=6))
        line = f"Question: what is {w}? Answer: {rng.choice(WORDS)}\n"
        parts.append(line)
        size += len(line)
    return "".join(parts)[:n_chars]


def profile_run(label, run):
    """One run under torch.profiler: device time by kernel group, the device's
    busy share of the wall time, and the top kernels.  ``run()`` returns its
    synchronised wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = {e.key: e.self_device_time_total for e in kernels}
    total = sum(us.values())
    if total == 0:
        log(f"[profile] {label}: the profiler recorded no device time")
        return
    groups = {"attention forward kernels": 0.0, "attention backward kernels": 0.0,
              "int8_matmul": 0.0, "fused_mlp": 0.0, "prompt_attn": 0.0,
              "int8 split-K reduce": 0.0, "matmuls": 0.0, "other": 0.0}
    for key, t in us.items():
        k = key.lower()
        group = ("attention backward kernels" if "flash_bwd" in key
                 else "attention forward kernels" if "mimic::" in key
                 else "int8_matmul" if "int8_matmul_kernel" in key
                 else "fused_mlp" if "fused_mlp_kernel" in key
                 else "prompt_attn" if "prompt_attn" in key
                 else "int8 split-K reduce" if "splitk_reduce" in key
                 else "matmuls" if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass"))
                 else "other")
        groups[group] += t
    log(f"[profile] {label}: {secs:.3f} s wall under the profiler, device busy "
        f"{total / 1e6:.3f} s ({total / 1e6 / secs:.1%}); "
        + ", ".join(f"{g} {t / 1e6:.3f} s" for g, t in groups.items()))
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x {e.key[:110]}")


def profile_call(name, run):
    profile_run(f"call {name}", lambda: run(name)[1])


def serving_calls():
    """name → (images, texts, prompt bucket) of the two serving calls."""
    return {
        "A": ([[synthetic_image(10 + i)] for i in range(4)],
              [f"Image:<image> {synthetic_text(20 + i, 250 + 40 * i)}Question: what is in "
               f"the image? Answer:" for i in range(4)], 512),
        "B": ([[synthetic_image(30 + i)] for i in range(2)],
              [f"Image:<image> {synthetic_text(40 + i, 3700 + 150 * i)}Question: what is in "
               f"the image? Answer:" for i in range(2)], 4096),
    }


def timed_generate(runner, calls, name):
    """runner.generate on call ``name``: (decoded strings, synchronised wall s)."""
    images, texts, _ = calls[name]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = runner.generate(images, texts, num_beams=NUM_BEAMS, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_main():
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from mimic_tpu_torch.shared import get_preset
    from mimic_tpu_torch.shift.params import init_shift_params

    t0 = time.perf_counter()
    runner = build_model("idefics2-8b-base", device="cuda", dtype=torch.bfloat16, seed=0,
                         length_buckets=(512, 4096))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in runner.module.buffers())
    log(f"[main] idefics2-8b-base: {n_params / 1e9:.3f} B random bf16 parameters made on "
        f"the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    gen = torch.Generator(device="cuda").manual_seed(1)
    runner.set_shift(init_shift_params(get_preset("mimic")[0], runner.cfg.text, gen,
                                       torch.device("cuda")))
    assert runner.logz2 == "unmasked"

    calls = serving_calls()
    for name, (images, texts, bucket) in calls.items():
        width = runner.processor(None, texts)["input_ids"].shape[1]
        if not bucket // 2 < width <= bucket:
            raise AssertionError(f"call {name}: prompt width {width} misses the {bucket} bucket")

    def run(name):
        return timed_generate(runner, calls, name)

    for name in calls:  # warm-up
        _, secs = run(name)
        log(f"[main] warm-up call {name}: {secs:.3f} s")

    reset_launch_counts()
    ATTN_PATH_LOG.clear()
    timings = {}
    for name, (images, texts, bucket) in calls.items():
        out, secs = run(name)
        timings[name] = secs
        if len(out) != len(texts) or not all(isinstance(s, str) for s in out):
            raise AssertionError(f"call {name}: bad output {out!r}")
        log(f"[main] call {name}: {len(texts)} requests, prompt bucket {bucket}, beam "
            f"{NUM_BEAMS}, {MAX_NEW_TOKENS} new tokens: {secs:.3f} s = "
            f"{len(texts) / secs:.3f} q/s; decoded {json.dumps(out)}")
    launches = dict(LAUNCHES)
    paths = list(ATTN_PATH_LOG)
    log(f"[main] kernel launches in the counted run: {launches}")
    log(f"[main] decoder attention paths: {paths.count('flash')} flash, "
        f"{paths.count('cached')} cached, {paths.count('xla')} xla")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if paths != (["flash"] + ["cached"] * (MAX_NEW_TOKENS - 1)) * len(calls):
        raise AssertionError(f"unexpected attention paths {paths}")
    for name in calls:
        profile_call(name, run)

    # the 8B prefill's last logits through the kernels against the plain path
    images, texts, bucket = calls["A"]
    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    logits = {}
    for attn_impl in ("flash", "xla"):
        logits[attn_impl], _, _ = tg._prefill(
            runner.params, runner.cfg, batch, bucket + MAX_NEW_TOKENS, runner.shift,
            "unmasked", torch.bfloat16, attn_impl,
        )
    a, b = logits["flash"], logits["xla"]
    if a.shape != (4, runner.cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"8B prefill logits: shape {tuple(a.shape)} or non-finite values")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    same_top = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[main] 8B prefill last logits, kernels vs plain attention (bf16): max abs diff "
        f"{(a - b).abs().max().item():.4f} of max |logit| {b.abs().max().item():.4f}, "
        f"min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE}), top-1 agreement {same_top:.2f}")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError("8B prefill logits through the kernels disagree with the plain path")

    # the token ids behind call A's strings: with random weights most ids are
    # >= 256, which the byte tokenizer decodes to nothing
    tok = runner.tokenizer
    result = tg.beam_generate(
        runner.params, runner.cfg, batch, max_new_tokens=MAX_NEW_TOKENS, num_beams=NUM_BEAMS,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, shift=runner.shift,
        logz2="unmasked", attn_impl="flash",
    )
    ids = result.tokens
    if (ids.shape != (4, MAX_NEW_TOKENS) or ids.min() < 0
            or ids.max() >= runner.cfg.text.vocab_size or not torch.isfinite(result.scores).all()):
        raise AssertionError(f"8B beam tokens out of range: {ids.tolist()} {result.scores}")
    log(f"[main] call A beam-3 token ids {ids.tolist()}, scores "
        f"{[round(x, 4) for x in result.scores.tolist()]}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return runner, launches


# ---------------------------------------------------------------------------
# phase 5: the MimIC train step on idefics2-8b-base
# ---------------------------------------------------------------------------


def make_train_batch(cfg, B=2, T_rec=2048, T_shift=256, n_demo_img=8, M=64):
    """The dual-pass batch of scripts/bench_8b_train.py, as device tensors:
    random token ids with 64 image tokens per image (8 demo images + the query
    image in the record pass, the query image in the shift pass), random 980 px
    pixels with full patch masks, and M gathered query tokens per row (the
    last M of each pass)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    size, S = cfg.vision.image_size, cfg.image_seq_len
    ng = size // cfg.vision.patch_size
    hi = min(32000, cfg.text.vocab_size)
    lo = min(300, hi // 2)
    full_ids = torch.randint(lo, hi, (B, T_rec), generator=gen, device=dev)
    for i in range(n_demo_img + 1):
        pos = 4 + i * (S + 128)
        full_ids[:, pos:pos + S] = cfg.image_token_id
    query_ids = torch.randint(lo, hi, (B, T_shift), generator=gen, device=dev)
    query_ids[:, 4:4 + S] = cfg.image_token_id

    def pixels(n):
        px = torch.randn(B, n, size, size, 3, generator=gen, device=dev).to(torch.bfloat16)
        return px, torch.ones(B, n, ng, ng, dtype=torch.int32, device=dev)

    full_px, full_patch = pixels(n_demo_img + 1)
    query_px, query_patch = pixels(1)
    idx = torch.arange(M, device=dev)[None].expand(B, M)
    return {
        "full_ids": full_ids, "full_mask": torch.ones(B, T_rec, dtype=torch.int32, device=dev),
        "full_pixels": full_px, "full_patch_mask": full_patch,
        "query_ids": query_ids, "query_mask": torch.ones(B, T_shift, dtype=torch.int32, device=dev),
        "query_pixels": query_px, "query_patch_mask": query_patch,
        "prefix_q_idx": idx + (T_rec - M), "shift_q_idx": idx + (T_shift - M),
        "q_valid": torch.ones(B, M, dtype=torch.bool, device=dev),
    }


def frozen_fingerprint(params) -> dict:
    """An exact per-leaf checksum of the frozen tree, slab by slab (no copy of
    the 16 GB tree): the int64 sum of the bit patterns, position-weighted."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if node.requires_grad:
            raise AssertionError(f"frozen leaf {'/'.join(path)} requires grad")
        bits = node.view(torch.int16) if node.element_size() == 2 else node.view(torch.int32)
        slabs = bits if bits.dim() > 2 else bits[None]
        total = 0
        for slab in slabs:
            flat = slab.reshape(-1).to(torch.int64)
            weights = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
            total += int((flat * weights).sum().item()) + int(flat.sum().item())
        out["/".join(path)] = total

    walk(params, ())
    return out


def phase_train_8b(runner):
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.lvlm import encode_images
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shared import get_preset
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("mimic")
    gen = torch.Generator(device="cuda").manual_seed(2)
    shift = init_shift_params(enc, cfg.text, gen, torch.device("cuda"))
    trainable = {"shift": shift}
    initial = {k: v.clone() for k, v in shift.items()}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                              logz2="unmasked")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    batch = make_train_batch(cfg)
    torch.cuda.synchronize()
    before = frozen_fingerprint(frozen)
    n_train = sum(v.numel() for v in shift.values())
    log(f"[train] idefics2-8b-base, mimic preset: {n_train / 1e6:.3f} M fp32 shift parameters "
        f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in shift.items())}); batch B2, record pass "
        f"{batch['full_ids'].shape[1]} tokens with {batch['full_pixels'].shape[1]} images, shift "
        f"pass {batch['query_ids'].shape[1]} tokens, {batch['q_valid'].shape[1]} gathered tokens")

    def run_step(b=batch):
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, b)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m, secs = run_step()
    log(f"[train] warm-up step: {secs:.3f} s, loss {float(m['loss']):.6f}")
    tfa.reset_launch_counts()
    tfb.reset_launch_counts()
    ATTN_PATH_LOG.clear()
    times, rows = [], []
    for i in range(TRAIN_STEPS):
        m, secs = run_step()
        times.append(secs)
        row = {k: float(v) for k, v in m.items()}
        rows.append(row)
        log(f"[train] step {i + 1}: {secs:.3f} s; " + ", ".join(f"{k} {v:.6g}" for k, v in row.items()))
    launches = {**tfa.LAUNCHES, **tfb.LAUNCHES}
    paths = list(ATTN_PATH_LOG)
    log(f"[train] {TRAIN_STEPS} counted steps: mean {sum(times) / len(times):.3f} s/step "
        f"(min {min(times):.3f}, max {max(times):.3f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; kernel launches {launches}; "
        f"decoder attention paths {paths}")
    if paths != ["flash"] * (2 * TRAIN_STEPS):
        raise AssertionError(f"a decoder call of the train step left the flash path: {paths}")
    # layer 0's q/k/v come from frozen embeddings and need no gradient, so the
    # backward kernels run for layers 1..L-1 of the shift pass
    want_bwd = (L - 1) * TRAIN_STEPS
    if launches["flash_bwd_dq"] != want_bwd or launches["flash_bwd_dkv"] != want_bwd:
        raise AssertionError(f"backward kernels launched {launches}, want {want_bwd} each")
    if launches["onepass_fwd"] == 0:
        raise AssertionError(f"the forward kernel never launched in the train step: {launches}")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()) or not row["grad_norm"] > 0:
            raise AssertionError(f"train metrics not finite or zero gradient: {row}")
    if frozen_fingerprint(frozen) != before:
        raise AssertionError("a frozen parameter changed during training")
    moved = {k: (state.trainable["shift"][k] - v).abs().max().item() for k, v in initial.items()}
    log(f"[train] frozen parameters bit-unchanged (per-leaf checksums); shift max |change| {moved}")
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"a shift leaf did not change: {moved}")

    profile_run("train step", lambda: run_step()[1])

    # gradients of one step through the kernels against the plain attention
    # path, on the same image features (the plain path's ViT attention would
    # materialise [18, 16, 4992, 4992] fp32 scores)
    with torch.no_grad():
        feats = {f"{p}_feats": encode_images(frozen, cfg, batch[f"{p}_pixels"],
                                             batch[f"{p}_patch_mask"], attn_impl="flash")
                 for p in ("full", "query")}
    fb = {k: v for k, v in batch.items() if "pixels" not in k and "patch" not in k}
    fb.update(feats)
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc),
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked")
    grads, losses = {}, {}
    for attn_impl in ("flash", "xla"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.trainable["shift"].items()}
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, fb, attn_impl=attn_impl, **loss_kw)
            grads[attn_impl] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[attn_impl] = float(loss.detach())
        torch.cuda.empty_cache()
    cos = {k: torch.nn.functional.cosine_similarity(
        grads["flash"][k].flatten(), grads["xla"][k].flatten(), dim=0).item()
        for k in grads["flash"]}
    log(f"[train] one step's gradients, kernels vs plain attention (bf16 model): loss "
        f"{losses['flash']:.6f} vs {losses['xla']:.6f}; per-leaf cosine {cos} "
        f"(need >= {MIN_GRAD_COSINE})")
    if min(cos.values()) < MIN_GRAD_COSINE:
        raise AssertionError("8B gradients through the kernels disagree with the plain path")

    # the step on precomputed image features: what a training vision-feature
    # cache (not ported yet) would leave of it
    run_step(fb)
    vision_free = [run_step(fb)[1] for _ in range(2)]
    log(f"[train] step on precomputed image features: {vision_free[0]:.3f} s, "
        f"{vision_free[1]:.3f} s")
    profile_run("train step on precomputed image features", lambda: run_step(fb)[1])
    return launches


# ---------------------------------------------------------------------------
# phase 6: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------


def _int8_weight(gen, shape, scale_base):
    """Random int8 weights and positive fp32 per-column scales around ``scale_base``."""
    wq = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    scale = (torch.rand(shape[:-2] + shape[-1:], generator=gen, device="cuda") + 0.5) * scale_base
    return wq, scale


def cold_ms(fn, layers, reps):
    """``cuda_ms`` of ``fn(layer)`` with the layer cycling through a stack larger
    than the card's 50 MB L2 cache, so every launch reads its weights from HBM
    as a decode step does (one layer's weights fit in L2)."""
    order = itertools.cycle(range(layers))
    return cuda_ms(lambda: fn(next(order)), reps)


def check_int8(label, kernel, plain, layers, layer, reps, fields=None):
    """``kernel(layer)`` against ``plain(layer)``: every output within
    TOL_INT8_REL of its max |reference| (``fields`` named "m": TOL_INT8_M
    absolute); then both timed cold.  Returns (per-field max abs err, ms, plain ms)."""
    got, want = kernel(layer), plain(layer)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    errs = {}
    for field, a, b in zip(fields or ("out",), got, want):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {field} {tuple(a.shape)} {a.dtype} or non-finite values")
        errs[field] = (a.float() - b.float()).abs().max().item()
        tol = TOL_INT8_M if field == "m" else TOL_INT8_REL * b.float().abs().max().item()
        if errs[field] > tol:
            raise AssertionError(f"{label}: {field} max abs err {errs[field]} > {tol}")
    return errs, cold_ms(kernel, layers, reps), cold_ms(plain, layers, reps)


def check_int8_matmul(label, seed, M, K, N, layers, layer, n_real, reps):
    """int8_matmul (stacked when ``layers``) at [M, K] x [K, N]; ``n_real``:
    the lm head's handle, N 128-padded in storage and sliced back by qdot,
    fp32 logits out."""
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    wq, scale = _int8_weight(gen, (layers, K, N) if layers else (K, N), 4e-4)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    if n_real:
        wq[:, n_real:] = 0
        handle = {"q8": wq, "scale": scale[:n_real].contiguous()}
        kernel = lambda _: tq.qdot(x, handle, preferred_element_type=torch.float32)
        plain = lambda _: tq.int8_matmul_plain(x, wq[:, :n_real], handle["scale"], torch.float32)
    else:
        kernel = lambda l: tq.int8_matmul_stacked(x, wq, scale, l)
        plain = lambda l: tq.int8_matmul_plain(x, wq[l], scale[l])
    errs, ms, plain_ms = check_int8(label, kernel, plain, max(layers, 1), layer, reps)
    log(f"[int8] {label}: int8_matmul M{M} K{K} N{n_real or N}"
        f"{f' layer {layer} of {layers}' if layers else ''}: max abs err {errs['out']:.3e} "
        f"(tol {TOL_INT8_REL} x max |ref|); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "int8_matmul", "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms}


def check_fused_mlp(label, seed, M, D, F, reps):
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers, layer = 4, 3
    gu, gs = _int8_weight(gen, (layers, D, 2 * F), 4e-4)
    dn, ds = _int8_weight(gen, (layers, F, D), 1e-4)
    x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    errs, ms, plain_ms = check_int8(
        label, lambda l: tq.fused_mlp_stacked(x, gu, gs, dn, ds, l),
        lambda l: tq.fused_mlp_plain(x, gu[l], gs[l], dn[l], ds[l]), layers, layer, reps)
    log(f"[int8] {label}: fused_mlp_int8 M{M} D{D} F{F} layer {layer} of {layers}: max abs err "
        f"{errs['out']:.3e} (tol {TOL_INT8_REL} x max |ref|); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return {"name": "fused_mlp_int8", "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms}


def check_prompt_attn(label, seed, B0, beams, Hkv, G, Sp, pads, reps):
    """prompt_attn_int8 on a 16-layer int8 prompt cache quantized on the card,
    folded layout, against its plain version (checked at layer 1)."""
    from mimic_tpu_torch.ops import decode_attention as tda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, layers = tda.HEAD_DIM, 16
    kv = [torch.randn(layers, B0, Sp, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    pk, pv = tda.quantize_prompt_kv(*kv)
    del kv
    qg = (torch.randn(B0 * beams, 1, Hkv, G, D, generator=gen, device="cuda") / D**0.5)
    qf = tda._fold(qg.to(torch.bfloat16), B0).contiguous()
    mask = torch.from_numpy(left_padded_mask(B0, Sp, pads)).cuda()
    args = lambda l: (qf, pk["q8"][l], pk["scale"][l], pv["q8"][l], pv["scale"][l], mask)
    errs, ms, plain_ms = check_int8(
        label, lambda l: tda._launch(*args(l)),
        lambda l: tda.prompt_attention_int8_plain(*args(l)), layers, 1, reps, fields="oml")
    log(f"[int8] {label}: prompt_attn_int8 B0 {B0} x beams {beams}, Hkv {Hkv}, G {G}, Sp {Sp}, "
        f"D {D}, left pads {list(pads)}: max abs err o {errs['o']:.3e} m {errs['m']:.3e} "
        f"l {errs['l']:.3e} (tol o, l {TOL_INT8_REL} x max |ref|, m {TOL_INT8_M}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "prompt_attn_int8", "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms}


def phase_int8_kernels():
    """The int8 kernels at idefics2-8b's decode shapes (D 4096, 32 heads / 8 kv
    heads, F 14336, vocab 32003): M = 12 is call A's decode (4 requests x 3
    beams), M = 6 call B's; M = 255 the largest M that takes the kernel.  The
    times kept for each kernel are those at its first (main-path) shape."""
    results = [
        check_int8_matmul("qkv-12", 20, 12, 4096, 6144, 32, 5, 0, reps=32),
        check_int8_matmul("o-12", 21, 12, 4096, 4096, 32, 7, 0, reps=32),
        check_int8_matmul("lm-head-12", 22, 12, 4096, 32128, 0, 0, 32003, reps=20),
        check_int8_matmul("qkv-6", 23, 6, 4096, 6144, 32, 31, 0, reps=32),
        check_int8_matmul("qkv-255", 24, 255, 4096, 6144, 32, 1, 0, reps=32),
        check_fused_mlp("mlp-12", 25, 12, 4096, 14336, reps=16),
        check_fused_mlp("mlp-6", 26, 6, 4096, 14336, reps=16),
        check_prompt_attn("call-B", 27, 2, NUM_BEAMS, 8, 4, 4096, (0, 250), reps=32),
        check_prompt_attn("call-A", 28, 4, NUM_BEAMS, 8, 4, 512, (130, 0, 37, 300), reps=32),
    ]
    summary = {}
    for r in results:
        s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
        s.setdefault("ms", r["ms"])
        s.setdefault("plain_ms", r["plain_ms"])
    return summary


# ---------------------------------------------------------------------------
# phase 7: the tiny int8 slice, kernels on the card against the CPU
# ---------------------------------------------------------------------------


class LogitSpy:
    """Records the last-position logits of every ``lvlm_forward`` call made by
    ``models/generate.py`` (the prefill first, then one per decode step)."""

    def __init__(self):
        from mimic_tpu_torch.models import generate as tg

        self.tg, self.logits = tg, []

    def __enter__(self):
        self.orig = self.tg.lvlm_forward

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.logits.append(out.logits[:, -1].float())
            return out

        self.tg.lvlm_forward = spy
        return self

    def __exit__(self, *exc):
        self.tg.lvlm_forward = self.orig


def _same_tree_bytes(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree_bytes(a[k], b[k]) for k in a)
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _int8_counts():
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    return {**tq.LAUNCHES, **tda.LAUNCHES}


def _reset_int8_counts():
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    tq.reset_launch_counts()
    tda.reset_launch_counts()


def phase_tiny_int8():
    from mimic_tpu_torch.models import decoder as td
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.shared import SimpleTokenizer, get_preset
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    # text width 128: no lane padding on the down projection, so the fused MLP is eligible
    cfg = tiny_cfg(tk, hidden_size=128)
    L = cfg.text.num_layers
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    # the shift as initialised: phase 3 already amplifies it through the attention kernels
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(7)
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8)] for _ in range(2)]
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    runners = {dev: LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev,
                               quant="int8") for dev in ("cpu", "cuda")}
    if not _same_tree_bytes(runners["cpu"].decode_params, runners["cuda"].decode_params):
        raise AssertionError("tiny int8: the int8 tree quantized on the card differs from the CPU's")
    new = 6
    logits, tokens = {}, {}
    for dev, r in runners.items():
        r.set_shift(shift)
        batch = r.process_input(images, texts, pad_to=128)
        _reset_int8_counts()
        with LogitSpy() as spy:
            tokens[dev] = tg.beam_generate(
                r.params, cfg, batch, max_new_tokens=new, num_beams=NUM_BEAMS,
                eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id, shift=r.shift,
                logz2="unmasked", attn_impl="flash" if dev == "cuda" else "xla",
                decode_params=r.decode_params,
            ).tokens.cpu()
        logits[dev] = [spy.logits[0].cpu(), spy.logits[1].cpu()]
    torch.cuda.synchronize()
    launches = _int8_counts()
    want = {"int8_matmul": (new - 1) * (2 * L + 1), "fused_mlp_int8": (new - 1) * L,
            "prompt_attn_int8": 0}
    errs = [(g - w).abs().max().item() for g, w in zip(logits["cuda"], logits["cpu"])]
    close = all(torch.allclose(g, w, rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
                for g, w in zip(logits["cuda"], logits["cpu"]))
    same = torch.equal(tokens["cuda"], tokens["cpu"])
    log(f"[tiny-int8] fp32, quant='int8' with a MimIC shift, kernels on the card vs plain on the "
        f"CPU: int8 trees bit-identical; prefill logits max abs err {errs[0]:.3e}, first decode "
        f"step {errs[1]:.3e} (rtol = atol = {TOL_TINY_FP32}: {close}); beam-3 tokens identical: "
        f"{same}; tokens {tokens['cuda'].tolist()}; launches {launches} (want {want})")
    if not close or not same or launches != want:
        raise AssertionError("tiny int8 slice: the kernel path disagrees with the plain path")

    # one decode step over an int8 prompt cache (beam 3, 128 prompt slots)
    tcfg = cfg.text
    B0, T = 2, 128
    B = B0 * NUM_BEAMS
    plain_dec = params["lm"]["decoder"]
    qdec = runners["cpu"].decode_params["lm"]["decoder"]
    embeds = torch.from_numpy(rng.normal(size=(B0, T, tcfg.hidden_size)).astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(B, 1, tcfg.hidden_size)).astype(np.float32))
    mask = torch.from_numpy(left_padded_mask(B0, T, [0, 40]))
    pre = td.decoder_forward(plain_dec, tcfg, embeds, td.make_causal_mask(mask),
                             td.positions_from_mask(mask), kv_cache=td.init_kv_cache(tcfg, B0, T, cpu),
                             key_mask=mask, cache_empty=True)
    prompt = [pre.kv_cache["k"], pre.kv_cache["v"]]
    mask_full = torch.cat([mask, torch.zeros(B0, 4, dtype=mask.dtype)], 1).repeat_interleave(
        NUM_BEAMS, 0)
    mask_full[:, T] = 1
    pos = mask.sum(-1).repeat_interleave(NUM_BEAMS)[:, None]
    quantized = {dev: tda.quantize_prompt_kv(*(p.to(dev) for p in prompt)) for dev in ("cpu", "cuda")}
    if not _same_tree_bytes(dict(enumerate(quantized["cpu"])), dict(enumerate(quantized["cuda"]))):
        raise AssertionError("tiny int8: prompt KV quantized on the card differs from the CPU's")
    hidden, paths = {}, {}
    for dev, (pk, pv) in quantized.items():
        gen_shape = (tcfg.num_layers, B, 4, tcfg.num_kv_heads, tcfg.head_size)
        cache = {"prompt_k": pk, "prompt_v": pv, "k": torch.zeros(gen_shape, device=dev),
                 "v": torch.zeros(gen_shape, device=dev), "length": T}
        _reset_int8_counts()
        td.ATTN_PATH_LOG.clear()
        hidden[dev] = td.decoder_forward(
            _to(qdec, dev), tcfg, step.to(dev), None, pos.to(dev), kv_cache=cache,
            key_mask=mask_full.to(dev)).hidden.cpu()
        paths[dev] = (list(td.ATTN_PATH_LOG), _int8_counts())
    err = (hidden["cuda"] - hidden["cpu"]).abs().max().item()
    close = torch.allclose(hidden["cuda"], hidden["cpu"], rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
    log(f"[tiny-int8] decode step over an int8 prompt cache (B0 {B0} x beams {NUM_BEAMS}, "
        f"{T} prompt slots), card vs CPU: hidden max abs err {err:.3e} (rtol = atol = "
        f"{TOL_TINY_FP32}: {close}); paths and launches {paths}")
    if (not close or paths["cuda"][0] != ["cached", "quant_kv"]
            or paths["cuda"][1]["prompt_attn_int8"] != L or paths["cpu"][1]["prompt_attn_int8"]):
        raise AssertionError("tiny int8 prompt-KV step: the kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# phase 8: the int8 serving modes on idefics2-8b-base
# ---------------------------------------------------------------------------


def dequantized_tree(tree):
    """A copy of ``tree`` with every int8 handle dequantized to bf16 [.., K, N]
    (layer by layer: no fp32 copy of a whole stack); other leaves shared."""
    from mimic_tpu_torch.ops.quant import dequantize, is_quantized

    if is_quantized(tree):
        q8, n = tree["q8"], tree["scale"].shape[-1]
        if q8.dim() == 2:
            return dequantize(tree).to(torch.bfloat16)
        out = torch.empty(q8.shape[0], q8.shape[1], n, dtype=torch.bfloat16, device=q8.device)
        for l in range(q8.shape[0]):
            out[l] = dequantize(dict(tree, layer=l)).to(torch.bfloat16)
        return out
    if isinstance(tree, dict):
        return {k: dequantized_tree(v) for k, v in tree.items()}
    return tree


def _row_cosine(a, b):
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


def phase_int8_8b(runner):
    import gc

    from mimic_tpu_torch.models import generate as tg

    calls = serving_calls()
    cfg = runner.cfg
    L = cfg.text.num_layers
    steps = MAX_NEW_TOKENS - 1
    want = {"int8_matmul": steps * (2 * L + 1), "fused_mlp_int8": steps * L, "prompt_attn_int8": 0}
    totals = dict.fromkeys(want, 0)
    shift = runner.shift

    def counted(name, label, expect):
        _, secs = timed_generate(runner, calls, name)
        log(f"[int8] warm-up call {name} ({label}): {secs:.3f} s")
        _reset_int8_counts()
        out, secs = timed_generate(runner, calls, name)
        got = _int8_counts()
        n = len(calls[name][1])
        log(f"[int8] call {name} ({label}): {n} requests, bucket {calls[name][2]}, beam "
            f"{NUM_BEAMS}, {MAX_NEW_TOKENS} new tokens: {secs:.3f} s = {n / secs:.3f} q/s; "
            f"launches {got}; decoded {json.dumps(out)}")
        if got != expect or len(out) != n:
            raise AssertionError(f"call {name} ({label}): launches {got}, want {expect}")
        for k in totals:
            totals[k] += got[k]
        return secs

    def batch_of(name):
        images, texts, bucket = calls[name]
        runner.tokenizer.padding_side = "left"  # as generate() pads
        return runner.process_input(images, texts, pad_to=bucket)

    def beam(batch, new, decode_params, **kw):
        tok = runner.tokenizer
        return tg.beam_generate(
            runner.params, cfg, batch, max_new_tokens=new, num_beams=NUM_BEAMS,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, shift=runner.shift,
            logz2=runner.logz2, attn_impl="flash", decode_params=decode_params, **kw)

    def first_step_logits(batch, decode_params, **kw):
        with LogitSpy() as spy:
            beam(batch, 2, decode_params, **kw)
        return spy.logits[1]

    # 1. "int8": the bf16 tree prefills, the int8 copy decodes; with the shift
    t0 = time.perf_counter()
    runner.set_quant("int8")
    torch.cuda.synchronize()
    log(f"[int8] set_quant('int8'): int8 decode copy made on the card in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    for name in calls:
        counted(name, "int8, shift", want)
    profile_run("int8 call A", lambda: timed_generate(runner, calls, "A")[1])

    batch = batch_of("A")
    deq = dequantized_tree(runner.decode_params)
    a = first_step_logits(batch, runner.decode_params)
    b = first_step_logits(batch, deq)
    del deq
    cos = _row_cosine(a, b)
    log(f"[int8] 8B first decode step (call A, beam {NUM_BEAMS}, shift): logits through the int8 "
        f"kernels vs a bf16 tree dequantized from the same handles: max abs diff "
        f"{(a - b).abs().max().item():.4f} of max |logit| {b.abs().max().item():.4f}, min row "
        f"cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if a.shape != (4 * NUM_BEAMS, cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"8B int8 logits: shape {tuple(a.shape)} or non-finite values")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError("8B int8 logits disagree with the dequantized bf16 path")

    # 2. call B without a shift: Tp = 4096 >= 1024 turns the int8 prompt KV on
    runner.set_shift(None)
    counted("B", "int8, no shift: int8 prompt KV", {**want, "prompt_attn_int8": steps * L})
    batch = batch_of("B")
    times = {True: [], False: []}
    for quant_kv in (True, False):  # warm-up
        beam(batch, MAX_NEW_TOKENS, runner.decode_params, quant_kv=quant_kv)
    for quant_kv in (True, False, True, False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        beam(batch, MAX_NEW_TOKENS, runner.decode_params, quant_kv=quant_kv)
        torch.cuda.synchronize()
        times[quant_kv].append(time.perf_counter() - t)
    on = first_step_logits(batch, runner.decode_params, quant_kv=True)
    off = first_step_logits(batch, runner.decode_params, quant_kv=False)
    cos = _row_cosine(on, off)
    log(f"[int8] call B without a shift through beam_generate: quant_kv on "
        f"{', '.join(f'{t:.3f}' for t in times[True])} s, off "
        f"{', '.join(f'{t:.3f}' for t in times[False])} s; first decode step logits on vs off: "
        f"max abs diff {(on - off).abs().max().item():.4f}, min row cosine {cos:.6f} "
        f"(need >= {MIN_LOGIT_COSINE})")
    if cos < MIN_LOGIT_COSINE or not torch.isfinite(on).all():
        raise AssertionError("8B int8 prompt-KV logits disagree with the bf16 prompt KV")
    runner.set_shift(shift)

    # 3. "int8-memory": one int8 tree serves the prefill and the decode steps
    t0 = time.perf_counter()
    runner.set_quant("int8-memory")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[int8] set_quant('int8-memory'): {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # the prefill's lm head (M = 4) is the one kernel launch outside the decode steps
    counted("A", "int8-memory, shift", {**want, "int8_matmul": want["int8_matmul"] + 1})
    log(f"[int8] int8-memory: peak device memory over call A {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after it")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mimic_tpu_torch.ops import _build

    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    info = _build.build()
    log(f"[build] {info['command'] or 'cached: ' + info['path']}")
    log(f"[build] nvcc for sm_90a: {info['seconds']:.1f} s compiling, "
        f"{time.perf_counter() - t0:.1f} s in all; library {os.path.relpath(info['path'], ROOT)}")
    _build.load_library()

    summary = phase_kernels()
    summary.update(phase_backward_kernels())
    summary.update(phase_int8_kernels())
    phase_tiny_reference()
    phase_tiny_train()
    phase_tiny_int8()
    runner, serve_launches = phase_main()
    train_launches = phase_train_8b(runner)
    int8_launches = phase_int8_8b(runner)

    # launches: each path's counted runs (serving, training, int8 serving), summed
    launches = {name: sum(d.get(name, 0) for d in (serve_launches, train_launches, int8_launches))
                for name in KERNEL_META}
    log(f"[card] kernel launches: serving {serve_launches}, training {train_launches}, "
        f"int8 serving {int8_launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on its main path: {launches}")
    kernels = [
        {"name": name, **KERNEL_META[name], "launches": launches[name], **summary[name]}
        for name in ("onepass_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "int8_matmul", "fused_mlp_int8", "prompt_attn_int8")
    ]
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
