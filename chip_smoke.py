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

The next-to-last line is {"kernels": [...]}, the last {"ok": true, "device": ...}.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

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


def tiny_cfg(tk):
    """tiny idefics2 with text head dim 128 (the flash path's) and a 70 px
    SigLIP with head dim 72 (the ViT's)."""
    import dataclasses

    from mimic_tpu_torch.shared import tiny_text

    cfg = tiny_text("idefics2", head_dim=128)
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
              "matmuls": 0.0, "other": 0.0}
    for key, t in us.items():
        k = key.lower()
        group = ("attention backward kernels" if "flash_bwd" in key
                 else "attention forward kernels" if "mimic::" in key
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

    calls = {
        "A": ([[synthetic_image(10 + i)] for i in range(4)],
              [f"Image:<image> {synthetic_text(20 + i, 250 + 40 * i)}Question: what is in "
               f"the image? Answer:" for i in range(4)], 512),
        "B": ([[synthetic_image(30 + i)] for i in range(2)],
              [f"Image:<image> {synthetic_text(40 + i, 3700 + 150 * i)}Question: what is in "
               f"the image? Answer:" for i in range(2)], 4096),
    }
    for name, (images, texts, bucket) in calls.items():
        width = runner.processor(None, texts)["input_ids"].shape[1]
        if not bucket // 2 < width <= bucket:
            raise AssertionError(f"call {name}: prompt width {width} misses the {bucket} bucket")

    def run(name):
        images, texts, _ = calls[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = runner.generate(images, texts, num_beams=NUM_BEAMS, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

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
    phase_tiny_reference()
    phase_tiny_train()
    runner, serve_launches = phase_main()
    train_launches = phase_train_8b(runner)

    # launches: each path's counted run (serving, then training), summed
    launches = {name: serve_launches.get(name, 0) + train_launches[name] for name in KERNEL_META}
    log(f"[card] kernel launches: serving {serve_launches}, training {train_launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on its main path: {launches}")
    kernels = [
        {"name": name, **KERNEL_META[name], "launches": launches[name], **summary[name]}
        for name in ("onepass_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
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
