#!/usr/bin/env python3
"""Drive mimic_tpu_torch's serving path once on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure propagates: non-zero exit, no result line):

1. build   — compile the CUDA kernels (mimic_tpu_torch/ops/csrc/*.cu) with nvcc
             for sm_90a; print the build time and the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card, bf16,
             at the shapes the serving path gives it (ViT rows, eval-protocol
             prefill, long prefill, a ragged key axis); max abs error against
             stated tolerances, and both times from CUDA events.
3. slice   — a tiny idefics2 in fp32 (ViT head dim 72, text head dim 128): the
             serving path through the kernels on the card must give the beam-3
             tokens of the plain path on the CPU, and prefill logits within 1e-4.
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


# ---------------------------------------------------------------------------
# phase 3: tiny fp32 slice, kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def phase_tiny_reference():
    import dataclasses

    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from mimic_tpu_torch.shared import SimpleTokenizer, get_preset, tiny_text
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_text("idefics2", head_dim=128)
    cfg = cfg.replace(
        text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size),
        vision=dataclasses.replace(cfg.vision, hidden_size=144, num_heads=2, image_size=70),
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )
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


def profile_call(name, run):
    """One more run of a call under torch.profiler: device time by kernel
    group, the device's busy share of the wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = run(name)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = {e.key: e.self_device_time_total for e in kernels}
    total = sum(us.values())
    if total == 0:
        log(f"[profile] call {name}: the profiler recorded no device time")
        return
    groups = {"attention kernels": 0.0, "matmuls": 0.0, "other": 0.0}
    for key, t in us.items():
        k = key.lower()
        group = ("attention kernels" if "mimic::" in key
                 else "matmuls" if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass"))
                 else "other")
        groups[group] += t
    log(f"[profile] call {name}: {secs:.3f} s wall under the profiler, device busy "
        f"{total / 1e6:.3f} s ({total / 1e6 / secs:.1%}); "
        + ", ".join(f"{g} {t / 1e6:.3f} s" for g, t in groups.items()))
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x {e.key[:110]}")


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
    phase_tiny_reference()
    launches = phase_main()

    kernels = [
        {"name": name, **KERNEL_META[name], "launches": launches[name], **summary[name]}
        for name in ("onepass_fwd", "flash_fwd")
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
