"""Tilings of mimic_tpu_torch's bf16 attention forward at the CLIP towers' rows.

Builds ``scripts/attn_fwd_tiling_sweep.cu`` (every tiling of ``VARIANTS`` in
one library, from ``mimic_tpu_torch/ops/csrc/attn_mma.cuh``), then on one
CUDA card:

- at idefics-9b's CLIP ViT-H rows (B68 H16 T=S=384, 257 keys, D80) and
  llava-1.5's CLIP ViT-L rows (B4 H16 T=S=640, 577 keys, D64): each tiling
  against the plain version, its CTAs per SM, and its device time through CUDA
  graphs in turns with ``onepass_fwd`` as the package builds it and
  ``scaled_dot_product_attention``;
- every tiling of a head dim on ``EDGES`` (ragged rows and keys, masked first
  and last key tiles, causal with and without lse_u, a batch with no
  attendable key, both tile-visiting rules) against the plain version.

Prints ptxas's registers and barriers for each tiling; exits 1 if a check
fails.  Run from the repository's root on a machine with a card and nvcc:

    python3 scripts/attn_fwd_tiling_sweep.py             # this tree's attn_mma.cuh
    python3 scripts/attn_fwd_tiling_sweep.py --csrc DIR  # the kernel sources in DIR (e.g.
                                                         # the parent's ops/csrc), the
                                                         # wrapper's times still this tree's
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from mimic_tpu_torch.ops import _build  # noqa: E402
from mimic_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# variant of the .cu -> (head dim, warpgroups per CTA, ring slots, CTAs per SM)
VARIANTS = {0: (80, 2, 3, 1), 1: (80, 1, 2, 4), 2: (80, 1, 3, 3),
            3: (64, 2, 3, 2), 4: (64, 1, 2, 5), 5: (64, 1, 2, 4), 6: (64, 1, 3, 3),
            7: (64, 1, 4, 3)}
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
]


def name(variant):
    D, nwg, slots, per_sm = VARIANTS[variant]
    return f"D{D} {nwg} warpgroup(s), {slots} slots, {per_sm} CTAs/SM"


def build(out_dir, csrc):
    out = os.path.join(out_dir, "libattn_fwd_tiling_sweep.so")
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-shared", "-I", csrc, "-o", out,
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
        if "Performance Loss" in line:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_fwd_tiling_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    csrc = str(_build.CSRC)
    if sys.argv[1:2] == ["--csrc"]:
        csrc = os.path.abspath(sys.argv[2])
    print(cs.card_line(), f"kernel sources {csrc}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok, n = True, 0
    with tempfile.TemporaryDirectory(prefix="attn_sweep_") as tmp:
        lib = build(tmp, csrc)
        for case in (cs.CLIP_VIT_CASE, cs.CLIP_L_VIT_CASE_ARGS):
            label, _, seed, B, T, S, H, Hkv, D, mask = case[:10]
            q, k, v, km = cs.kernel_inputs(seed, B, T, S, H, Hkv, D, mask)
            want = tfa.attention_plain(q, k, v, km, causal=False, need_unmasked=False)
            runs = {}
            for var in (i for i, c in VARIANTS.items() if c[0] == D):
                runs[name(var)] = launcher(lib, var, q, k, v, km, False, False, 0)
                ok &= check(f"{label} {name(var)}", runs[name(var)](), want, km, False, False,
                            True)
                n += 1
                print(f"[occupancy] {name(var)}: {lib.sweep_occupancy(var)} CTAs per SM", flush=True)
            runs["onepass_fwd through its wrapper"] = lambda: tfa._launch(
                "onepass_fwd", q, k, v, km, False, None, False)
            allowed = (km > 0)[:, None, None, :]
            runs["scaled_dot_product_attention"] = lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=allowed)
            times = {r: [] for r in runs}
            for _ in range(3):
                for r, fn in runs.items():
                    times[r].append(cs.cuda_ms(fn, 50, graph=True))
            for r, ts in times.items():
                print(f"[time] {label} B{B} T{T} S{S} H{H} D{D}, {r}: "
                      + ", ".join(f"{t:.4f}" for t in ts) + " ms (device time through CUDA graphs)",
                      flush=True)
        from test_torch_kernels import make_inputs

        for D in sorted({c[0] for c in VARIANTS.values()}):
            for B, T, S, H, Hkv, causal, nu, skip, lp, spans in EDGES:
                arrays = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=D, left_pad=lp, seed=T,
                                     zero_spans=spans)
                q, k, v = (torch.from_numpy(x).cuda().to(torch.bfloat16) for x in arrays[:3])
                km = torch.from_numpy(arrays[3]).cuda()
                want = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=nu)
                for var in (i for i, c in VARIANTS.items() if c[0] == D):
                    got = launcher(lib, var, q, k, v, km, causal, nu, skip)()
                    ok &= check(f"{name(var)} B{B} T{T} S{S} H{H}/{Hkv} causal={causal} "
                                f"need_unmasked={nu} skip_tiles={skip} left pad {lp} spans {spans}",
                                got, want, km, causal, nu, not skip)
                    n += 1
        torch.cuda.synchronize()
    print(f"[sweep] {n} checks against the plain version: {'all passed' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
