"""Tilings of mimic_tpu_torch's bf16 attention forward at the vision towers' rows.

Builds ``scripts/attn_fwd_tiling_sweep.cu`` (every tiling of ``VARIANTS`` in
one library, from ``mimic_tpu_torch/ops/csrc/attn_mma.cuh``), then on one
CUDA card:

- at the CLIP towers' rows (head dims 80 and 64): idefics-9b's ViT-H
  (B68 H16 T=S=384, 257 keys, D80) and llava-1.5's ViT-L (B4 H16 T=S=640,
  577 keys, D64);
- at the D72 towers' rows (``D72_CASES``): SigLIP at 980 px as ``chip_smoke.py``
  times it (B1 H16 T=S=4992, 53 of every 70 keys) and as the train cell's two
  tower calls and the eval's call run it (B18, B2 and B32, each image's own patch
  mask from the cell's image sizes), MoonViT (B18 H16 T=S=1792, each image's own rows) and
  SigLIP at 384 px (B10 H16 T=S=768, 729 keys);

each tiling of the head dim against the plain version (on two images of a
batch: the plain version materialises every score), its CTAs per SM, and its
device time through CUDA graphs in turns with ``onepass_fwd`` as the package
builds it and ``scaled_dot_product_attention``; at the ViT row also each
tiling's largest and rms error against the plain version in fp32; then every
tiling of a head dim on ``EDGES`` (ragged rows and keys, masked first and last
key tiles, causal with and without lse_u, a batch with no attendable key, both
tile-visiting rules) against the plain version.

Prints ptxas's registers, spills and warnings for each tiling; exits 1 if a
check fails.  Run from the repository's root on a machine with a card and nvcc:

    python3 scripts/attn_fwd_tiling_sweep.py             # this tree's attn_mma.cuh
    python3 scripts/attn_fwd_tiling_sweep.py --d 72      # the D72 tilings alone
    python3 scripts/attn_fwd_tiling_sweep.py --csrc DIR  # the kernel sources in DIR (e.g.
                                                         # the parent's ops/csrc), the
                                                         # wrapper's times still this tree's
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from mimic_tpu_torch.ops import _build  # noqa: E402
from mimic_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# variant of the .cu -> (head dim, form, consumer warpgroups per CTA, keys a tile, ring
# slots, CTAs per SM); "full sweep": D72's tiling without the end at the last key
VARIANTS = {0: (80, "producer warp", 2, 64, 3, 1), 1: (80, "one warpgroup", 1, 64, 2, 4),
            2: (80, "one warpgroup", 1, 64, 3, 3), 3: (64, "producer warp", 2, 64, 3, 2),
            4: (64, "one warpgroup", 1, 64, 2, 5), 5: (64, "one warpgroup", 1, 64, 2, 4),
            6: (64, "one warpgroup", 1, 64, 3, 3), 7: (64, "one warpgroup", 1, 64, 4, 3),
            8: (72, "producer warp, full sweep", 2, 64, 3, 2),
            9: (72, "producer warp", 2, 64, 3, 2)}
# (B, T, S, H, Hkv, causal, need_unmasked, skip_tiles, left pad, zero key spans)
EDGES = [
    (2, 384, 384, 4, 4, False, False, 0, 0, ((257, 384),)),
    (2, 384, 384, 4, 4, False, False, 1, 0, ((257, 384),)),
    (2, 500, 500, 4, 4, True, True, 0, 77, None),
    (2, 1000, 1000, 4, 4, False, True, 0, 0, None),
    (2, 333, 200, 4, 2, True, False, 0, 150, None),
    (2, 333, 200, 4, 2, True, False, 1, 150, None),
    (2, 200, 333, 8, 2, False, False, 0, 0, ((0, 333),)),
    (2, 200, 333, 8, 2, False, False, 1, 0, ((0, 70), (300, 333))),
    (2, 640, 640, 4, 4, False, False, 0, 130, ((577, 640),)),
    (2, 130, 70, 4, 4, True, False, 0, 20, None),
    (2, 1000, 1000, 4, 4, True, False, 1, 300, ((600, 700),)),
    (2, 700, 700, 4, 4, False, False, 0, 700, None),
    (2, 700, 700, 4, 4, False, False, 1, 700, None),
]

# the cells' image sizes (h, w): the train cells' nine, the eval's 32
TRAIN_SIZES = [(480, 640), (640, 480), (427, 640), (480, 640), (640, 427), (480, 640),
               (512, 640), (480, 640), (640, 480)]
EVAL_SIZES = [(480, 640), (640, 480), (427, 640), (480, 640), (640, 427), (480, 640),
              (512, 640), (480, 640)] * 4


def siglip980_mask(sizes):
    """SigLIP at 980 px: each image resized to a longest edge of 980, its patches of
    14 px on a 70 x 70 grid (row-major), padded to 4992 keys."""
    km = np.zeros((len(sizes), 4992), np.int32)
    for i, (h, w) in enumerate(sizes):
        scale = 980 / max(h, w)
        rows, cols = (min(70, math.ceil(round(x * scale) / 14)) for x in (h, w))
        grid = np.zeros((70, 70), np.int32)
        grid[:rows, :cols] = 1
        km[i, :4900] = grid.reshape(-1)
    return km


def moonvit_mask(sizes):
    """MoonViT at native resolution: an image padded to a multiple of 28 px has
    (2 ceil(h / 28)) (2 ceil(w / 28)) patches, its rows first; the batch padded to 1792."""
    km = np.zeros((len(sizes), 1792), np.int32)
    for i, (h, w) in enumerate(sizes):
        km[i, :4 * math.ceil(h / 28) * math.ceil(w / 28)] = 1
    return km


def vit_row_mask():
    """chip_smoke.py's ViT row: a 70 x 53 valid grid (interior zeros at every row end)."""
    grid = np.zeros((70, 70), np.int32)
    grid[:, :53] = 1
    km = np.zeros((1, 4992), np.int32)
    km[0, :4900] = grid.reshape(-1)
    return km


# (label, seed, H, T = S, key mask, graph reps, the batch items checked)
D72_CASES = [
    ("vit row", 0, 16, 4992, vit_row_mask(), 30, (0,)),
    ("cell-1 tower call", 30, 16, 4992, siglip980_mask(TRAIN_SIZES * 2), 3, (0, 1)),
    ("cell-1 second call", 34, 16, 4992, siglip980_mask(TRAIN_SIZES[:2]), 20, (0, 1)),
    ("eval call", 31, 16, 4992, siglip980_mask(EVAL_SIZES), 2, (0, 1)),
    ("moonvit", 32, 16, 1792, moonvit_mask(TRAIN_SIZES * 2), 10, (0, 2)),
    ("siglip-384", 33, 16, 768, np.repeat((np.arange(768) < 729)[None].astype(np.int32), 10, 0),
     50, (0, 9)),
]


def name(variant):
    D, form, nwg, bn, slots, per_sm = VARIANTS[variant]
    return f"D{D} {form}: {nwg} warpgroup(s), {bn}-key tiles, {slots} slots, {per_sm} CTA(s)/SM"


def build(out_dir, csrc, only_d=0):
    out = os.path.join(out_dir, f"libattn_fwd_tiling_sweep_{only_d}.so")
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-shared", f"-DSWEEP_D={only_d}", "-I", csrc, "-o", out,
           os.path.join(ROOT, "scripts", "attn_fwd_tiling_sweep.cu")]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed:\n{p.stderr[-4000:]}")
    print(f"[sweep] nvcc {time.perf_counter() - t:.1f} s", flush=True)
    lines = p.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "attn_fwd_mma" in line:
            print("[ptxas] " + " | ".join(x.replace("ptxas info    :", "").strip()
                                          for x in lines[i:i + 4]))
        if "Performance Loss" in line or "warning" in line.lower():
            print("[ptxas] " + line)
    lib = ctypes.CDLL(out)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # variant, q, k, v, key_mask, out, lse, lse_u, B, T, S, H, Hkv, scale, causal,
    # need_unmasked, skip_tiles, stream
    lib.sweep_attn.argtypes = [I] + [P] * 7 + [I] * 5 + [F, I, I, I, P]
    lib.sweep_attn.restype = I
    lib.sweep_occupancy.argtypes = [I]
    lib.sweep_occupancy.restype = I
    return lib


def launcher(lib, variant, q, k, v, km, causal, need_unmasked, skip_tiles):
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, T, H, dtype=torch.float32, device=q.device)
    lse_u = torch.empty_like(lse)
    kmi = (km != 0).to(torch.int32).contiguous()

    def launch():
        err = lib.sweep_attn(variant, q.data_ptr(), k.data_ptr(), v.data_ptr(), kmi.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), lse_u.data_ptr(), B, T, S, H, Hkv,
                             float(D ** -0.5), int(causal), int(need_unmasked), int(skip_tiles),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name(variant)}: CUDA error {err}")
        return out, lse, lse_u
    return launch


def check(label, got, want, km, causal, need_unmasked, every_key):
    """chip_smoke.py's bf16 tolerances: out within a rounding step of its largest
    reference element and 2^-7 in rms, lse and lse_u within 2e-3."""
    B, T = got[0].shape[:2]
    S = km.shape[1]
    allowed = km[:, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(T, S, dtype=torch.bool, device=km.device).tril()[None]
    valid = allowed.any(-1).expand(B, T)
    rows = (lambda x: x.float()) if every_key else (lambda x: x.float()[valid])
    ref, diff = rows(want[0]), rows(got[0]) - rows(want[0])
    worst = lambda x: x.abs().max().item() if x.numel() else 0.0  # noqa: E731
    tol = min(cs.TOL_OUT_BF16, cs.OUT_BF16_STEP * worst(ref) + cs.OUT_BF16_ABS)
    rms = lambda x: x.square().mean().sqrt().item() if x.numel() else 0.0  # noqa: E731
    errs = {"out": worst(diff), "lse": worst((got[1] - want[1])[valid]),
            "lse_u": worst(got[2] - want[2] if need_unmasked else (got[2] - want[2])[valid])}
    ok = (all(torch.isfinite(x.float()).all().item() for x in got) and errs["out"] <= tol
          and rms(diff) <= cs.OUT_BF16_REL_RMS * rms(ref) + 1e-30
          and max(errs["lse"], errs["lse_u"]) <= cs.TOL_LSE_BF16)
    if not ok:
        print(f"[check] {label}: {errs} (out tol {tol:.3e}) FAILED", flush=True)
    return ok


def time_in_turns(label, runs, reps):
    times = {r: [] for r in runs}
    for _ in range(3):
        for r, fn in runs.items():
            times[r].append(cs.cuda_ms(fn, reps, graph=True))
    for r, ts in times.items():
        print(f"[time] {label}, {r}: " + ", ".join(f"{t:.4f}" for t in ts)
              + " ms (device time through CUDA graphs)", flush=True)
    return times


def library_run(q, k, v, km):
    allowed = (km > 0)[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=allowed)


def clip_rows(lib, variants):
    ok, n = True, 0
    for case in (cs.CLIP_VIT_CASE, cs.CLIP_L_VIT_CASE_ARGS):
        label, _, seed, B, T, S, H, Hkv, D, mask = case[:10]
        mine = [i for i in variants if VARIANTS[i][0] == D]
        if not mine:
            continue
        q, k, v, km = cs.kernel_inputs(seed, B, T, S, H, Hkv, D, mask)
        want = tfa.attention_plain(q, k, v, km, causal=False, need_unmasked=False)
        runs = {}
        for var in mine:
            runs[name(var)] = launcher(lib, var, q, k, v, km, False, False, 0)
            ok &= check(f"{label} {name(var)}", runs[name(var)](), want, km, False, False, True)
            n += 1
            print(f"[occupancy] {name(var)}: {lib.sweep_occupancy(var)} CTAs per SM", flush=True)
        runs["onepass_fwd through its wrapper"] = lambda: tfa._launch(
            "onepass_fwd", q, k, v, km, False, None, False)
        runs["scaled_dot_product_attention"] = library_run(q, k, v, km)
        time_in_turns(f"{label} B{B} T{T} S{S} H{H} D{D}", runs, 50)
    return ok, n


def d72_rows(lib, variants):
    """Each D72 tiling at the towers' rows: checked on two images of the batch against
    the plain version, then timed in turns; at the ViT row the error against fp32."""
    ok, n = True, 0
    mine = [i for i in variants if VARIANTS[i][0] == 72]
    if not mine:
        return ok, n
    for label, seed, H, T, mask, reps, items in D72_CASES:
        B = mask.shape[0]
        q, k, v, km = cs.kernel_inputs(seed, B, T, T, H, H, 72, mask)
        runs = {name(var): launcher(lib, var, q, k, v, km, False, False, 0) for var in mine}
        sel = list(items)
        want = tfa.attention_plain(q[sel], k[sel], v[sel], km[sel], causal=False,
                                   need_unmasked=False)
        exact = None
        if label == "vit row":  # the plain version in fp32: p is not rounded to bf16
            exact = tfa.attention_plain(q.float(), k.float(), v.float(), km, causal=False,
                                        need_unmasked=False)[0]
        for var in mine:
            got = [x[sel] for x in runs[name(var)]()]
            ok &= check(f"{label} {name(var)}", got, want, km[sel], False, False, True)
            n += 1
            if exact is not None:
                d = runs[name(var)]()[0].float() - exact
                print(f"[error] {label} {name(var)}: max |out - fp32 plain| "
                      f"{d.abs().max().item():.6e}, rms {d.square().mean().sqrt().item():.6e}",
                      flush=True)
        del want, exact
        for var in mine:
            print(f"[occupancy] {name(var)}: {lib.sweep_occupancy(var)} CTAs per SM", flush=True)
        runs["onepass_fwd through its wrapper"] = lambda: tfa._launch(
            "onepass_fwd", q, k, v, km, False, None, False)
        runs["scaled_dot_product_attention"] = library_run(q, k, v, km)
        keys = int(km.sum().item())
        time_in_turns(f"{label} B{B} T=S={T} H{H} D72 ({keys} keys in all)", runs, reps)
        del q, k, v, km, runs
        torch.cuda.empty_cache()
    return ok, n


def edges(lib, variants):
    from test_torch_kernels import make_inputs

    ok, n = True, 0
    for D in sorted({VARIANTS[i][0] for i in variants}):
        for B, T, S, H, Hkv, causal, nu, skip, lp, spans in EDGES:
            arrays = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=D, left_pad=lp, seed=T,
                                 zero_spans=spans)
            q, k, v = (torch.from_numpy(x).cuda().to(torch.bfloat16) for x in arrays[:3])
            km = torch.from_numpy(arrays[3]).cuda()
            want = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=nu)
            for var in (i for i in variants if VARIANTS[i][0] == D):
                got = launcher(lib, var, q, k, v, km, causal, nu, skip)()
                ok &= check(f"{name(var)} B{B} T{T} S{S} H{H}/{Hkv} causal={causal} "
                            f"need_unmasked={nu} skip_tiles={skip} left pad {lp} spans {spans}",
                            got, want, km, causal, nu, not skip)
                n += 1
    return ok, n


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_fwd_tiling_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", default=str(_build.CSRC))
    parser.add_argument("--d", type=int, default=0, help="one head width's tilings alone")
    args = parser.parse_args()
    csrc = os.path.abspath(args.csrc)
    print(cs.card_line(), f"kernel sources {csrc}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = [i for i, c in VARIANTS.items() if args.d in (0, c[0])]
    ok, n = True, 0
    with tempfile.TemporaryDirectory(prefix="attn_sweep_") as tmp:
        lib = build(tmp, csrc, args.d)
        for part in (clip_rows, d72_rows, edges):
            part_ok, part_n = part(lib, variants)
            ok &= part_ok
            n += part_n
        torch.cuda.synchronize()
    print(f"[sweep] {n} checks against the plain version: {'all passed' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
