"""mimic_tpu_torch.ops.flash_attention and .flash_backward without JAX: the
dispatch rule, the launch counters, the no-fallback rules, the autograd
Function and, on a CUDA card, each CUDA kernel against its plain version in
fp32 and bf16, and gradients through the kernels against gradients through
the plain version.

This file imports no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the CPU
suite.)  Without a card the ``cuda``-marked tests skip with a reason.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from mimic_tpu_torch.ops import flash_attention as tfa
from mimic_tpu_torch.ops import flash_backward as tfb


def make_inputs(B=2, T=128, S=128, H=4, Hkv=2, D=32, seed=0, left_pad=0, zero_spans=None,
                Dv=None):
    """``zero_spans``: instead of the default mask, all ones but keys [a, b) of
    every row (whole key tiles without an attendable key), then ``left_pad``.
    ``Dv``: v's head width (default D)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dv or D)).astype(np.float32)
    km = np.ones((B, S), np.int32)
    if zero_spans is None:
        km[0, S - S // 5:] = 0       # suffix padding
        km[-1, 40:44] = 0            # interior PAD separator
    for a, b in zero_spans or ():
        km[:, a:b] = 0
    if left_pad:
        km[0, :left_pad] = 0     # left-padded prompt: causal rows < left_pad see no key
    return q, k, v, km


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _valid_rows(km, T, causal):
    """[B,T] rows with at least one attendable key."""
    S = km.shape[1]
    allowed = km[:, None, :] > 0
    if causal:
        allowed = allowed & np.tril(np.ones((T, S), bool))[None]
    return np.broadcast_to(allowed.any(-1), (km.shape[0], T))


def test_dispatch_routes_shapes_like_jax(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "_route", lambda name, *a: calls.append(name) or (None,) * 3)
    q = torch.zeros(1, 512, 2, 64)
    kv = torch.zeros(1, 512, 2, 64)
    tfa.flash_attention(q, kv, kv, None, causal=True)
    long_kv = torch.zeros(1, 4096, 2, 64)
    tfa.flash_attention(torch.zeros(1, 4096, 2, 64), long_kv, long_kv, None, causal=True)
    vit_kv = torch.zeros(1, 4992, 2, 64)
    tfa.flash_attention(torch.zeros(1, 4992, 2, 64), vit_kv, vit_kv, None, causal=False)
    ragged = torch.zeros(1, 1000, 2, 64)
    tfa.flash_attention(ragged, ragged, ragged, None, causal=False)
    tiny = torch.zeros(1, 128, 1, 64)  # no tiny-shape cut-off to a plain path
    tfa.flash_attention(tiny, tiny, tiny, None)
    assert calls == ["onepass_fwd", "flash_fwd", "onepass_fwd", "flash_fwd", "onepass_fwd"]


def test_cpu_path_never_launches_or_builds():
    from mimic_tpu_torch.ops import _build

    tfa.reset_launch_counts()
    q, k, v, km = make_inputs(D=72)
    tfa.flash_attention(_t(q), _t(k), _t(v), _t(km), causal=False, need_unmasked=False)
    tfa.flash_attention(_t(q)[:, :100], _t(k)[:, :100], _t(v)[:, :100], _t(km)[:, :100])
    assert tfa.LAUNCHES == {"flash_fwd": 0, "onepass_fwd": 0}
    assert _build._lib is None


def test_cpu_backward_never_launches_and_grad_goes_through_the_function():
    from mimic_tpu_torch.ops import _build

    tfb.reset_launch_counts()
    q, k, v, km = make_inputs(D=128, left_pad=10)
    q, k, v = (_t(x).requires_grad_(True) for x in (q, k, v))
    out, lse, lse_u = tfa.flash_attention(q, k, v, _t(km), causal=True)
    # the kernels write through raw pointers: only the Function carries gradients
    assert type(out.grad_fn).__name__ == "FlashAttentionDiffBackward"
    assert lse.grad_fn is out.grad_fn and lse_u.grad_fn is out.grad_fn
    (out.sum() + lse.sum() + lse_u.sum()).backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    assert tfb.LAUNCHES == {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert _build._lib is None
    with torch.no_grad():  # no graph wanted: the plain dispatch, no Function
        assert tfa.flash_attention(q, k, v, _t(km))[0].grad_fn is None


def test_backward_on_other_devices_raises():
    q = torch.zeros(1, 128, 2, 128, device="meta")
    lse = torch.zeros(1, 128, 2, device="meta")
    with pytest.raises(ValueError):
        tfb.flash_attention_backward(q, q, q, None, q, lse, lse, q, None, None)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, None)


def test_d72_launches_are_counted_apart(monkeypatch):
    """Each bf16 launch at head width 72 counts on the program's counter of the
    vision towers' launches, while a profile records; a launch at 128 does not.  The
    launch itself is stubbed: the wrapper runs on CPU tensors against a library that
    does nothing; and so is the profile, whose flag alone the counter reads (a real
    profile of the CPU, started first in a process, leaves later profiles there
    blind to the card's kernels)."""
    import contextlib
    import types

    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.utils import tracing

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    profiler = types.SimpleNamespace(_is_profiler_enabled=True)
    monkeypatch.setattr(tracing, "_autograd_profiler", profiler)

    def launch(name, D, dtype=torch.bfloat16):
        q = torch.zeros(1, 128, 2, D, dtype=dtype)
        tfa._launch(name, q, q, q, None, False, None, False)

    tfa.reset_launch_counts()
    tracing.reset()
    launch("onepass_fwd", 72)
    launch("flash_fwd", 72)
    launch("onepass_fwd", 128)
    launch("flash_fwd", 72, torch.float32)  # the scalar fp32 kernel
    counts = tracing.recorded()["counts"]
    assert counts.get(tfa.D72_FORM_COUNTER) == 2
    assert tfa.LAUNCHES == {"flash_fwd": 2, "onepass_fwd": 2}
    profiler._is_profiler_enabled = False
    launch("onepass_fwd", 72)  # outside a profile: counted by LAUNCHES alone
    assert tracing.recorded()["counts"].get(tfa.D72_FORM_COUNTER) == 2
    tracing.reset()
    tfa.reset_launch_counts()


def test_import_compiles_nothing():
    code = (
        "import sys, subprocess\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import mimic_tpu_torch.ops.flash_attention, mimic_tpu_torch.ops._build as b\n"
        "import mimic_tpu_torch.models.factory\n"
        "assert not calls and b._lib is None, calls\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against the plain version (bf16 and fp32)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


KERNEL_CASES = [
    # (kernel, B, T, S, H, Hkv, D, causal, need_unmasked, left_pad[, zero key spans])
    ("onepass_fwd", 1, 256, 640, 4, 4, 72, False, False, 0),
    ("onepass_fwd", 2, 256, 256, 8, 2, 128, True, True, 20),
    ("flash_fwd", 1, 640, 640, 8, 2, 128, True, True, 20),
    ("flash_fwd", 2, 1000, 1000, 4, 4, 72, False, True, 0),
    ("flash_fwd", 2, 300, 300, 8, 2, 128, True, False, 10),
    # the tensor-core kernel's tiles (128 query rows per CTA at D72 and D128, 64 per
    # warpgroup, 64 keys at D72):
    # the first key tiles fully masked (left padding past whole tiles)
    ("flash_fwd", 2, 512, 512, 8, 2, 128, True, True, 200),
    ("onepass_fwd", 2, 384, 384, 4, 4, 72, False, False, 130),
    # interior key tiles fully masked, under each tile-visiting rule
    ("onepass_fwd", 2, 512, 512, 4, 4, 72, False, False, 0, ((128, 330), (400, 470))),
    ("flash_fwd", 2, 500, 500, 8, 2, 128, True, False, 0, ((128, 330),)),
    ("flash_fwd", 2, 500, 500, 8, 2, 128, True, True, 0, ((0, 70), (128, 330))),
    # T != S
    ("onepass_fwd", 2, 512, 640, 4, 4, 72, False, False, 0),
    ("flash_fwd", 1, 200, 333, 8, 2, 128, False, True, 0),
    ("flash_fwd", 2, 100, 200, 4, 4, 72, True, True, 20),
    # the train step's record pass
    ("onepass_fwd", 2, 2048, 2048, 8, 2, 128, True, True, 300),
    # D72 with S not a multiple of the key tile, and T not of the query tile
    ("onepass_fwd", 1, 1000, 1000, 4, 4, 72, False, False, 0),
    ("flash_fwd", 2, 130, 70, 4, 4, 72, False, False, 0),
    # D72 under the causal mask, with and without lse_u
    ("onepass_fwd", 2, 500, 500, 4, 4, 72, True, False, 77),
    ("flash_fwd", 2, 500, 500, 4, 4, 72, True, True, 150),
    # D80 (the idefics-9b CLIP tower): its rows, the class token and 256 patches
    # padded to 384 keys, under both entry points; causal with lse_u; a ragged S
    ("onepass_fwd", 2, 384, 384, 4, 4, 80, False, False, 0, ((257, 384),)),
    ("flash_fwd", 2, 384, 384, 4, 4, 80, False, False, 0, ((257, 384),)),
    ("onepass_fwd", 2, 500, 500, 4, 4, 80, True, True, 77),
    ("flash_fwd", 2, 1000, 1000, 4, 4, 80, False, True, 0),
    # D64 (the llava-1.5 CLIP ViT-L tower): the class token and 576 patches padded
    # to 640 keys, under both entry points; the first key tile wholly masked; causal
    # with lse_u
    ("onepass_fwd", 2, 640, 640, 4, 4, 64, False, False, 0, ((577, 640),)),
    ("flash_fwd", 2, 640, 640, 4, 4, 64, False, False, 0, ((577, 640),)),
    ("onepass_fwd", 2, 384, 384, 4, 4, 64, False, False, 70),
    ("flash_fwd", 2, 500, 500, 4, 4, 64, True, True, 77),
    # D64 and D80 run one warpgroup of 64 rows per CTA and end the sweep at the batch's
    # last attendable key where every row may drop the tiles past it: a last CTA of
    # ragged rows with the first two key tiles and the last two wholly masked; causal
    # without lse_u, where the CTAs before a batch's first key keep every tile; the
    # sweep ended under flash_fwd's diagonal; a batch with no attendable key at all
    # (nothing to end at: left padding over every key); causal with lse_u under flash_fwd
    ("onepass_fwd", 2, 200, 384, 4, 4, 80, False, False, 130, ((257, 384),)),
    ("flash_fwd", 2, 200, 384, 4, 4, 80, False, False, 130, ((257, 384),)),
    ("onepass_fwd", 2, 333, 333, 4, 4, 80, True, False, 150),
    ("onepass_fwd", 2, 200, 333, 8, 2, 80, False, False, 333),
    ("flash_fwd", 2, 500, 500, 4, 4, 80, True, True, 77),
    ("onepass_fwd", 2, 200, 640, 4, 4, 64, False, False, 130, ((577, 640),)),
    ("flash_fwd", 2, 200, 640, 4, 4, 64, False, False, 130, ((577, 640),)),
    ("onepass_fwd", 2, 333, 333, 4, 4, 64, True, False, 150),
    ("flash_fwd", 2, 1000, 1000, 4, 4, 64, True, False, 300),
    ("onepass_fwd", 2, 200, 333, 8, 2, 64, False, False, 333),
    # D72's sweep ended at the batch's last attendable key: causal with lse_u under
    # onepass_fwd (no end); a batch with
    # no attendable key under each tile-visiting rule; interior tiles wholly masked
    # and the sweep ended at the diagonal under flash_fwd; GQA with T > S, the first
    # key tiles masked; masked first and last tiles under flash_fwd
    ("onepass_fwd", 2, 500, 500, 4, 4, 72, True, True, 77),
    ("onepass_fwd", 2, 700, 700, 4, 4, 72, False, False, 700),
    ("flash_fwd", 2, 700, 700, 4, 4, 72, False, False, 700),
    ("flash_fwd", 2, 1000, 1000, 4, 4, 72, True, False, 300, ((600, 700),)),
    ("onepass_fwd", 2, 333, 200, 4, 2, 72, True, False, 150),
    ("flash_fwd", 2, 200, 333, 8, 2, 72, False, False, 0, ((0, 70), (300, 333))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    name, B, T, S, H, Hkv, D, causal, need_unmasked, left_pad = case[:10]
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=D, left_pad=left_pad, seed=T,
                              zero_spans=case[10] if len(case) > 10 else None)
    dt = getattr(torch, dtype)
    args = [_t(x).to(cuda_device, dt) for x in (q, k, v)] + [_t(km).to(cuda_device)]
    before = tfa.LAUNCHES[name]
    got = tfa._launch(name, *args, causal, None, need_unmasked)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[name] == before + 1
    want = tfa.attention_plain(*args, causal=causal, need_unmasked=need_unmasked)
    valid = torch.from_numpy(_valid_rows(km, T, causal).copy()).to(cuda_device)
    # bf16: out differs by at most a rounding step of the output (|out| < 4);
    # lse is fp32 from identical bf16 inputs, differing in summation order
    atol_out, atol_lse = (2e-5, 1e-5) if dtype == "float32" else (3e-2, 2e-3)
    every_key = name == "onepass_fwd" or need_unmasked
    if dtype == "bfloat16":
        # |out| depends on the shape (many attendable keys average v down): hold it to
        # one bf16 rounding step (2^-7) at its own largest reference value, each row to
        # two steps at the row's largest, and its rms error to 2^-7 of the reference's
        # rms (a bf16 rounding is 2^-9 / sqrt(3) in rms)
        sel = (lambda x: x.float()) if every_key else (lambda x: x.float()[valid])
        ref, diff = sel(want[0]), sel(got[0]) - sel(want[0])
        atol_out = min(atol_out, 2.0 ** -7 * ref.abs().max().item() + 1e-4)
        rel_rms = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
        assert rel_rms <= 2.0 ** -7, rel_rms
        row_ratio = (diff.abs().amax(-1) / (ref.abs().amax(-1) + 1e-4)).max().item()
        assert row_ratio <= 2.0 ** -6, row_ratio
    checks = [
        (got[0], want[0], None if every_key else valid, atol_out),
        (got[1], want[1], valid, atol_lse),
        (got[2], want[2], None if need_unmasked else valid, atol_lse),
    ]
    for a, b, rows, atol in checks:
        assert torch.isfinite(a.float()).all()
        diff = (a.float() - b.float()).abs()
        diff = diff if rows is None else diff[rows]
        assert diff.max().item() <= atol, (diff.max().item(), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", tfa.KERNEL_HEAD_DIMS)
def test_tiled_plain_version_walks_the_kernels_tiles_on_card(cuda_device, D, Dv):
    """attention_tiled_plain (the CPU tests' model of the bf16 forward) and the
    compiled kernel name the same tiling."""
    import ctypes

    from mimic_tpu_torch.ops import _build

    block_m, group_rows, block_n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _build.load_library().mimic_attn_fwd_tiling(
        D, Dv, ctypes.byref(block_m), ctypes.byref(group_rows), ctypes.byref(block_n))
    assert rc == 0
    assert (block_m.value, group_rows.value, block_n.value) == (
        tfa.TILE_BLOCK_M[D], tfa.TILE_GROUP_ROWS, tfa.TILE_BLOCK_N[D])


def _sweep_module():
    """scripts/attn_fwd_tiling_sweep.py: the towers' key masks, and the library of
    tilings that holds D72 with and without the sweep's end side by side."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "attn_fwd_tiling_sweep.py")
    spec = importlib.util.spec_from_file_location("attn_fwd_tiling_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the D72 towers' calls: (B, T = S, the key mask's maker, the images checked); the
# masks are the cells': SigLIP at 980 px (the train cell's tower call of 18 images and
# the eval's of 32: landscape images padded at the end, portrait ones in every row),
# MoonViT's rows of each image, SigLIP at 384 px
D72_TOWER_CASES = {
    "siglip-980-train": (18, 4992, lambda m: m.siglip980_mask(m.TRAIN_SIZES * 2), (0, 1, 6)),
    "siglip-980-eval": (32, 4992, lambda m: m.siglip980_mask(m.EVAL_SIZES), (2, 4, 31)),
    "moonvit": (18, 1792, lambda m: m.moonvit_mask(m.TRAIN_SIZES * 2), (0, 2, 6)),
    "siglip-384": (10, 768, lambda m: np.repeat((np.arange(768) < 729)[None], 10, 0), (0, 9)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tower", list(D72_TOWER_CASES))
def test_d72_at_the_towers_rows_on_card(cuda_device, tower, monkeypatch):
    """onepass_fwd at head width 72 on the towers' own calls (16 heads, non-causal,
    no lse_u, as the towers call it), against the plain version on a few images of
    the batch (the plain version holds every score), by chip_smoke.py's bf16
    tolerances; each launch counted on the towers' counter while the profiler's
    flag is up (stubbed: the file's later tests profile the card)."""
    import types

    from mimic_tpu_torch.utils import tracing

    B, T, make_mask, items = D72_TOWER_CASES[tower]
    km = make_mask(_sweep_module()).astype(np.int32)
    rng = np.random.default_rng(T + B)
    q, k, v = (_t(rng.normal(size=(B, T, 16, 72)).astype(np.float32)).to(cuda_device,
                                                                          torch.bfloat16)
               for _ in range(3))
    km = _t(km).to(cuda_device)
    tracing.reset()
    monkeypatch.setattr(tracing, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    got = tfa._launch("onepass_fwd", q, k, v, km, False, None, False)
    torch.cuda.synchronize()
    assert tracing.recorded()["counts"][tfa.D72_FORM_COUNTER] == 1
    tracing.reset()
    sel = list(items)
    want = tfa.attention_plain(q[sel], k[sel], v[sel], km[sel], causal=False,
                               need_unmasked=False)
    out, ref = got[0][sel].float(), want[0].float()
    diff = out - ref
    assert torch.isfinite(out).all()
    assert diff.abs().max().item() <= 2.0 ** -7 * ref.abs().max().item() + 1e-4
    assert (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item() <= 2.0 ** -7
    assert (got[1][sel] - want[1]).abs().max().item() <= 2e-3
    assert torch.equal(got[2], got[1])


@pytest.mark.cuda
def test_d72_is_no_less_accurate_than_the_full_sweep_on_card(cuda_device, tmp_path):
    """D72 as the package builds it against the same tiling with the full sweep it had
    before its sweep ended at the last attendable key (the sweep's variant 8, built
    beside it from the same sources): on chip_smoke.py's ViT row (B1 H16 T=S=4992, 53
    of every 70 keys) its largest error against the plain version in fp32 is no
    larger, and on the train cell's first images (landscape ones end early) its
    output, lse and lse_u are the full sweep's bit for bit: the tiles it does not
    load are those every row drops."""
    sweep = _sweep_module()
    assert sweep.VARIANTS[8][:2] == (72, "producer warp, full sweep")
    lib = sweep.build(str(tmp_path), sweep._build.CSRC, 72)
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.normal(size=(1, 4992, 16, 72)).astype(np.float32)).to(cuda_device,
                                                                            torch.bfloat16)
               for _ in range(3))
    km = _t(sweep.vit_row_mask()).to(cuda_device)
    exact = tfa.attention_plain(q.float(), k.float(), v.float(), km, causal=False,
                                need_unmasked=False)[0]
    new = tfa._launch("onepass_fwd", q, k, v, km, False, None, False)[0]
    old = sweep.launcher(lib, 8, q, k, v, km, False, False, 0)()[0]
    torch.cuda.synchronize()
    err_new = (new.float() - exact).abs().max().item()
    err_old = (old.float() - exact).abs().max().item()
    assert err_new <= err_old, (err_new, err_old)
    del exact
    km = _t(sweep.siglip980_mask(sweep.TRAIN_SIZES[:3])).to(cuda_device)
    q, k, v = (_t(rng.normal(size=(3, 4992, 16, 72)).astype(np.float32)).to(cuda_device,
                                                                            torch.bfloat16)
               for _ in range(3))
    new = [x.clone() for x in tfa._launch("onepass_fwd", q, k, v, km, False, None, False)]
    old = sweep.launcher(lib, 8, q, k, v, km, False, False, 0)()
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# (B, T, S, H, Hkv, causal, need_unmasked, left_pad[, zero key spans]); head dim 128
BWD_CASES = [
    (2, 256, 256, 8, 2, True, True, 37),
    (1, 640, 640, 4, 1, True, True, 0),
    (2, 300, 300, 8, 2, True, False, 20),
    (2, 200, 200, 4, 4, False, True, 0),
    (1, 130, 130, 4, 2, False, False, 0),
    # whole padded key tiles (every tile still visited with need_unmasked), and without
    (2, 512, 512, 8, 2, True, True, 200),
    (2, 512, 512, 8, 2, True, False, 200),
    # interior key tiles with no attendable key, ragged T
    (2, 333, 333, 8, 2, True, True, 0, ((64, 192),)),
    (2, 333, 333, 4, 4, False, False, 0, ((64, 192),)),
    # every key of batch row 1 masked: p = 0 on its rows, the p_u terms kept
    (2, 100, 100, 4, 1, True, True, 0, ((0, 100),)),
]


def _bwd_inputs(case, dtype, dev, seed):
    B, T, S, H, Hkv, causal, need_unmasked, left_pad = case[:8]
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=128, left_pad=left_pad, seed=seed,
                              zero_spans=case[8] if len(case) > 8 else None)
    if len(case) > 8 and case[8] == ((0, S),):
        km[0] = 1  # only batch row 1 without keys
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed + 1)
    g_out = rng.normal(size=q.shape).astype(np.float32)
    g_lse, g_lse_u = (rng.normal(size=(B, T, H)).astype(np.float32) for _ in range(2))
    return ([_t(x).to(dev, dt) for x in (q, k, v)], _t(km).to(dev), _t(g_out).to(dev, dt),
            _t(g_lse).to(dev), _t(g_lse_u).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernels_match_plain_on_card(cuda_device, case, dtype):
    causal, need_unmasked = case[5], case[6]
    (q, k, v), km, g_out, g_lse, g_lse_u = _bwd_inputs(case, dtype, cuda_device, case[1])
    out, lse, lse_u = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    args = (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u)
    kw = dict(causal=causal, need_unmasked=need_unmasked)
    before = dict(tfb.LAUNCHES)
    got = tfb.flash_attention_backward(*args, **kw)
    again = tfb.flash_attention_backward(*args, **kw)
    torch.cuda.synchronize()
    assert {n: tfb.LAUNCHES[n] - before[n] for n in before} == {"flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), f"{name}: two launches gave different bits"
    want = tfb.flash_attention_backward_plain(*args, **kw)
    # fp32: summation order only; bf16: each gradient is rounded to bf16 once
    # (relative 2^-8) from fp32 sums of the same bf16 inputs, with p and ds
    # rounded to bf16 in the kernel and kept in fp32 by the plain version
    rtol = 1e-4 if dtype == "float32" else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item(), (name, err)
    if dtype == "bfloat16":
        # the kernels' own algorithm (p and ds rounded to bf16, the kernels' tiles and
        # cluster split), on the CPU: both sides are fp32 sums of the same rounded
        # operands, rounded once to bf16, so they differ where a rounding falls the
        # other way: at most one bf16 step at the largest value (2^-7 of it), and in
        # rms far less than one rounding (2^-9 of the reference's rms)
        from mimic_tpu_torch.ops.quant import _sm_count

        split = tfb.dkv_split(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                              _sm_count(cuda_device.index or 0))
        model = tfb.flash_attention_backward_tiled_plain(*(x.cpu() for x in args), **kw,
                                                         split=split)
        for name, a, b in zip(("dq", "dk", "dv"), got, model):
            a, b = a.float().cpu(), b.float()
            err = (a - b).abs().max().item()
            assert err <= 2.0 ** -7 * b.abs().max().item(), (name, err)
            rms = ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()
            assert rms <= 2.0 ** -9, (name, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_backward_dkv_cluster_splits_agree_on_card(cuda_device, split):
    """The bf16 dkv kernel under every cluster split: the same bits on two
    launches, and the unsplit result up to fp32 summation order."""
    case = (2, 256, 256, 8, 2, True, True, 61)
    (q, k, v), km, g_out, g_lse, g_lse_u = _bwd_inputs(case, "bfloat16", cuda_device, 7)
    out, lse, lse_u = tfa.attention_plain(q, k, v, km)
    args = (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, True, None, True)
    run = lambda s: tfb._launch_backward(*args, kernels=("flash_bwd_dkv",), split=s)[1:]  # noqa: E731
    one, got, again = run(1), run(split), run(split)
    torch.cuda.synchronize()
    for a, b, c in zip(got, one, again):
        assert torch.equal(a, c)
        assert (a.float() - b.float()).abs().max().item() <= 2.0 ** -7 * b.float().abs().max().item()


@pytest.mark.cuda
def test_backward_tiled_plain_version_names_the_kernels_tiling_on_card(cuda_device):
    """flash_attention_backward_tiled_plain (the CPU tests' model of the bf16
    backward) and the compiled kernels name the same tiling."""
    import ctypes

    from mimic_tpu_torch.ops import _build

    vals = [ctypes.c_int() for _ in range(5)]
    assert _build.load_library().mimic_flash_bwd_tiling(*(ctypes.byref(x) for x in vals)) == 0
    assert [x.value for x in vals] == [tfb.TILE_DQ_ROWS, tfb.TILE_DQ_KEYS, tfb.TILE_DKV_KEYS,
                                       tfb.TILE_DKV_ROWS, tfb.MAX_SPLIT]


@pytest.mark.cuda
@pytest.mark.parametrize("need_unmasked", [True, False])
def test_gradients_through_kernels_match_plain_on_card(cuda_device, need_unmasked):
    # no left padding: for a row with no attendable key the contract (JAX's
    # too) gives p = 0, while autograd through the plain forward would see its
    # uniform mean of v
    case = (2, 256, 256, 8, 2, True, need_unmasked, 0)
    (q, k, v), km, g_out, g_lse, g_lse_u = _bwd_inputs(case, "float32", cuda_device, 5)

    def grads(attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out, lse, lse_u = attention(*leaves, km, causal=True, need_unmasked=need_unmasked)
        ((out * g_out).sum() + (lse * g_lse).sum() + (lse_u * g_lse_u).sum()).backward()
        return [x.grad for x in leaves]

    before = dict(tfb.LAUNCHES)
    got = grads(tfa.flash_attention)
    torch.cuda.synchronize()
    assert tfb.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    # autograd through the plain version: the reference the kernels replace.
    # Without need_unmasked both lse outputs are the masked lse, and the JAX
    # contract drops lse_u's cotangent; the plain autograd keeps it
    want = grads(tfa.attention_plain) if need_unmasked else grads(
        lambda *a, **kw: (lambda o, l, lu: (o, l, lu.detach()))(*tfa.attention_plain(*a, **kw)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


# latent attention (Kimi-VL's MLA): q / k heads 192 wide, v heads 128, bf16 only
# (kernel, B, T, S, H, Hkv, causal, need_unmasked, left_pad[, zero key spans])
MLA_CASES = [
    # the MimIC step's passes: the record pass (flash_fwd past ONEPASS_MAX_S, no
    # lse_u, right padding) and the shift pass (onepass_fwd, lse_u)
    ("flash_fwd", 2, 5120, 5120, 16, 16, True, False, 0, ((4990, 5120),)),
    ("onepass_fwd", 2, 768, 768, 16, 16, True, True, 0, ((700, 768),)),
    # left padding, interior masked tiles, lse_u under flash_fwd, T != S, ragged rows
    ("flash_fwd", 2, 512, 512, 4, 4, True, True, 200),
    ("onepass_fwd", 2, 500, 500, 4, 2, True, False, 0, ((128, 330),)),
    ("flash_fwd", 1, 200, 333, 4, 4, False, True, 0),
    ("onepass_fwd", 2, 130, 256, 4, 4, False, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_CASES)
def test_latent_attention_kernel_matches_plain_on_card(cuda_device, case):
    """The (192, 128) forward against the plain version: out within bf16
    rounding, lse and lse_u to fp32 summation order; and the kernel's name."""
    name, B, T, S, H, Hkv, causal, need_unmasked, left_pad = case[:9]
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=192, Dv=128, left_pad=left_pad,
                              seed=T, zero_spans=case[9] if len(case) > 9 else None)
    args = [_t(x).to(cuda_device, torch.bfloat16) for x in (q, k, v)] + [_t(km).to(cuda_device)]
    got = tfa._launch(name, *args, causal, None, need_unmasked)
    torch.cuda.synchronize()
    assert got[0].shape == (B, T, H, 128)
    want = tfa.attention_plain(*args, causal=causal, need_unmasked=need_unmasked)
    valid = torch.from_numpy(_valid_rows(km, T, causal).copy()).to(cuda_device)
    every_key = name == "onepass_fwd" or need_unmasked
    sel = (lambda x: x.float()) if every_key else (lambda x: x.float()[valid])
    ref, diff = sel(want[0]), sel(got[0]) - sel(want[0])
    assert diff.abs().max().item() <= 2.0 ** -7 * ref.abs().max().item() + 1e-4
    assert (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item() <= 2.0 ** -7
    assert (got[1] - want[1]).abs()[valid].max().item() <= 2e-3
    lse_u_rows = None if need_unmasked else valid
    d_u = (got[2] - want[2]).abs()
    assert (d_u if lse_u_rows is None else d_u[lse_u_rows]).max().item() <= 2e-3


@pytest.mark.cuda
def test_latent_attention_kernels_have_their_own_names_on_card(cuda_device):
    """The (192, 128) kernels run under names that hold the shared metrics'
    substrings and one of their own; the D128 forward's name is not theirs."""
    q, k, v, km = make_inputs(B=1, T=256, S=256, H=2, Hkv=2, D=192, Dv=128)
    q128, k128, v128, _ = make_inputs(B=1, T=256, S=256, H=2, Hkv=2, D=128)
    dev, bf = cuda_device, torch.bfloat16
    mla = [_t(x).to(dev, bf).requires_grad_(True) for x in (q, k, v)]
    d128 = [_t(x).to(dev, bf) for x in (q128, k128, v128)]
    kmask = _t(km).to(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, lse, lse_u = tfa.flash_attention(*mla, kmask)
        (out.float().sum() + lse_u.sum()).backward()
        tfa.flash_attention(*d128, kmask)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    fwd = [n for n in names if "attn_fwd_mma_kernel" in n]
    assert any("mla_attn_fwd_mma_kernel" in n for n in fwd), names
    assert any("mla_attn_fwd_mma_kernel" not in n for n in fwd), names
    assert any("mla_bwd_dq_mma_kernel" in n for n in names), names
    assert any("mla_bwd_dkv_mma_kernel" in n for n in names), names


# (B, T, S, H, Hkv, causal, need_unmasked, left_pad[, zero key spans]); heads 192 / 128
MLA_BWD_CASES = [
    (2, 768, 768, 16, 16, True, True, 0, ((700, 768),)),   # the MimIC step's shift pass
    (2, 256, 256, 8, 2, True, True, 37),
    (2, 300, 300, 4, 4, True, False, 20),
    (1, 130, 200, 4, 4, False, True, 0),
    (2, 333, 333, 4, 4, True, True, 0, ((64, 192),)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_BWD_CASES)
def test_latent_attention_backward_matches_plain_on_card(cuda_device, case):
    """dq and dk at 192, dv at 128, gradients through lse and lse_u: against
    the plain version within bf16 rounding, and against the kernels' own
    algorithm on the CPU (flash_attention_backward_tiled_plain)."""
    B, T, S, H, Hkv, causal, need_unmasked, left_pad = case[:8]
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=192, Dv=128, left_pad=left_pad,
                              seed=T, zero_spans=case[8] if len(case) > 8 else None)
    dev, bf = cuda_device, torch.bfloat16
    q, k, v = (_t(x).to(dev, bf) for x in (q, k, v))
    km = _t(km).to(dev)
    rng = np.random.default_rng(T + 1)
    g_out = _t(rng.normal(size=(B, T, H, 128)).astype(np.float32)).to(dev, bf)
    g_lse, g_lse_u = (_t(rng.normal(size=(B, T, H)).astype(np.float32)).to(dev) for _ in range(2))
    out, lse, lse_u = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    args = (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u)
    kw = dict(causal=causal, need_unmasked=need_unmasked)
    got = tfb.flash_attention_backward(*args, **kw)
    again = tfb.flash_attention_backward(*args, **kw)
    torch.cuda.synchronize()
    assert [x.shape[-1] for x in got] == [192, 192, 128]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = tfb.flash_attention_backward_plain(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-2 * b.float().abs().max().item(), (name, err)
    from mimic_tpu_torch.ops.quant import _sm_count

    split = tfb.dkv_split(B, T, S, H, Hkv, _sm_count(dev.index or 0))
    model = tfb.flash_attention_backward_tiled_plain(*(x.cpu() for x in args), **kw, split=split)
    for name, a, b in zip(("dq", "dk", "dv"), got, model):
        a, b = a.float().cpu(), b.float()
        assert (a - b).abs().max().item() <= 2.0 ** -7 * b.abs().max().item(), name
        assert ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item() <= 2.0 ** -9


def test_latent_attention_widths_take_bf16_only():
    """fp32 at (192, 128) raises before any launch or build, forward and backward."""
    q = torch.zeros(1, 128, 2, 192, device="meta")
    k, v = torch.zeros(1, 128, 2, 192, device="meta"), torch.zeros(1, 128, 2, 128, device="meta")
    with pytest.raises(TypeError, match="bf16 only"):
        tfa._launch("onepass_fwd", q, k, v, None, True, None, True)
    with pytest.raises(ValueError, match="not in"):
        tfa._launch("onepass_fwd", q, k, k, None, True, None, True)


# ---------------------------------------------------------------------------
# the int8 kernels (ops/quant.py, ops/decode_attention.py)
# ---------------------------------------------------------------------------


def _quantized(rng, shape):
    from mimic_tpu_torch.ops.quant import quantize_weight

    return quantize_weight(_t(rng.normal(size=shape).astype(np.float32)))


def test_int8_cpu_paths_never_launch_or_build(monkeypatch):
    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    # earlier cuda-marked tests may have loaded the library: fail on any use of it
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    tq.reset_launch_counts()
    tda.reset_launch_counts()
    rng = np.random.default_rng(30)
    gu, down = _quantized(rng, (2, 128, 256)), _quantized(rng, (2, 128, 128))
    x = _t(rng.normal(size=(3, 128)).astype(np.float32))
    tq.qdot(x, dict(gu, layer=1))
    assert tq.fused_mlp(x, dict(gu, layer=1), dict(down, layer=1)) is None  # CPU: declined
    tq.fused_mlp_stacked(x, gu["q8"], gu["scale"], down["q8"], down["scale"], 1)
    pk, pv = tda.quantize_prompt_kv(*(_t(rng.normal(size=(2, 1, 128, 2, 128)).astype(np.float32))
                                      for _ in range(2)))
    q = _t(rng.normal(size=(2, 1, 2, 2, 128)).astype(np.float32))
    tda.prompt_attention_int8(q, dict(pk, layer=1), dict(pv, layer=1), torch.ones(1, 128))
    assert tq.LAUNCHES == {"int8_matmul": 0, "fused_mlp_int8": 0, "w8a8_matmul": 0}
    assert tda.LAUNCHES == {"prompt_attn_int8": 0}


def test_int8_other_devices_raise():
    from mimic_tpu_torch.ops import quant as tq

    w = {"q8": torch.zeros(64, 128, dtype=torch.int8, device="meta"),
         "scale": torch.zeros(128, device="meta")}
    with pytest.raises(ValueError):
        tq.qdot(torch.zeros(2, 64, device="meta"), w)
    with pytest.raises(ValueError):
        tq.int8_matmul(torch.zeros(2, 64, device="meta"), w["q8"], w["scale"])


INT8_MATMUL_CASES = [
    # (M, K, N, stacked layer or None)
    (12, 256, 384, 1),
    (6, 200, 256, None),     # ragged K
    (4, 512, 128, 0),
    (40, 128, 256, None),    # several 16-row blocks
    # every row count of the bf16 path's cases: one n8 operand up to 8 rows, two
    # up to 16, then several 16-row blocks; K splits of 1 to 8 (a cluster each)
    (1, 1024, 256, 0),
    (16, 4096, 256, None),
    (17, 640, 384, 1),
    (64, 2048, 128, None),
    (255, 512, 256, 2),
    (12, 4100, 512, None),   # ragged K, not a multiple of 8: the rows are padded
    (12, 968, 1024, 0),      # ragged K, a partial last tile in the last split
    (4, 8192, 128, None),    # a cluster of 8 K splits
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", INT8_MATMUL_CASES)
def test_int8_matmul_matches_plain_on_card(cuda_device, case, dtype):
    from mimic_tpu_torch.ops import quant as tq

    M, K, N, layer = case
    rng = np.random.default_rng(M * K)
    dt = getattr(torch, dtype)
    q = _quantized(rng, (3, K, N) if layer is not None else (K, N))
    wq, sc = q["q8"].to(cuda_device), q["scale"].to(cuda_device)
    x = _t(rng.normal(size=(M, K)).astype(np.float32)).to(cuda_device, dt)
    before = tq.LAUNCHES["int8_matmul"]
    if layer is None:
        got = tq.int8_matmul(x, wq, sc)
        want = tq.int8_matmul_plain(x, wq, sc)
    else:
        got = tq.int8_matmul_stacked(x, wq, sc, layer)
        want = tq.int8_matmul_plain(x, wq[layer], sc[layer])
    torch.cuda.synchronize()
    assert tq.LAUNCHES["int8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (M, N)
    # fp32: summation order only; bf16: one rounding of an fp32 sum (2^-8)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err
    # a second launch on the same inputs gives the same bits (no atomics)
    again = tq.int8_matmul(x, wq, sc) if layer is None else tq.int8_matmul_stacked(x, wq, sc, layer)
    assert torch.equal(_bits(again), _bits(got))
    if dtype == "bfloat16":
        # the tensor-core kernel's split, summed in rank order: only the order
        # inside one split is the tensor cores' own
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        ks = tq.mma_plan(M, K, -(-N // tq.MMA_BLOCK_N), sms)
        w2, s2 = (wq, sc) if layer is None else (wq[layer], sc[layer])
        tiled = tq.int8_matmul_tiled_plain(x, w2, s2, ks)
        err = (got.float() - tiled.float()).abs().max().item()
        assert err <= rtol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 12, 17])
def test_lm_head_through_qdot_on_card(cuda_device, M):
    """The lm head's handle: N 128-padded in storage (32128 stored, 32003 real
    at idefics2-8b; here 640 / 600), fp32 logits sliced back by qdot."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(44 + M)
    w = {k: v.to(cuda_device) for k, v in _quantized(rng, (256, 600)).items()}
    assert w["q8"].shape == (256, 640)
    x = _t(rng.normal(size=(M, 256)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    before = tq.LAUNCHES["int8_matmul"]
    got = tq.qdot(x, w, preferred_element_type=torch.float32)
    assert tq.LAUNCHES["int8_matmul"] == before + 1
    want = tq.int8_matmul_plain(x, w["q8"][:, :600], w["scale"], torch.float32)
    assert got.shape == (M, 600) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_qdot_routes_at_the_kernel_cut_off_on_card(cuda_device):
    """Below KERNEL_MAX_M rows qdot launches int8_matmul, from it on it takes
    the dequantized torch.matmul (an ``a8`` handle: w8a8_matmul from
    W8A8_MIN_M rows)."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(45)
    w = {k: v.to(cuda_device) for k, v in _quantized(rng, (2, 128, 256)).items()}
    w["layer"] = 1
    for M, launched in ((tq.KERNEL_MAX_M - 1, 1), (tq.KERNEL_MAX_M, 0)):
        x = _t(rng.normal(size=(M, 128)).astype(np.float32)).to(cuda_device, torch.bfloat16)
        tq.reset_launch_counts()
        got = tq.qdot(x, w)
        assert tq.LAUNCHES == {"int8_matmul": launched, "fused_mlp_int8": 0, "w8a8_matmul": 0}
        want = tq.int8_matmul_plain(x, w["q8"][1], w["scale"][1])
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (M, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,D,F", [(12, 256, 128), (6, 128, 128), (20, 128, 192),
                                   (1, 512, 256), (16, 1024, 512), (64, 256, 320),
                                   (255, 128, 128), (12, 512, 4096)])
def test_fused_mlp_matches_plain_on_card(cuda_device, M, D, F, dtype):
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(M + D + F)
    dt = getattr(torch, dtype)
    gu, down = _quantized(rng, (2, D, 2 * F)), _quantized(rng, (2, F, D))
    args = [t.to(cuda_device) for t in (gu["q8"], gu["scale"], down["q8"], down["scale"])]
    x = _t(rng.normal(size=(M, D)).astype(np.float32) / np.sqrt(D)).to(cuda_device, dt)
    before = tq.LAUNCHES["fused_mlp_int8"]
    got = tq.fused_mlp_stacked(x, *args, 1)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["fused_mlp_int8"] == before + 1
    want = tq.fused_mlp_plain(x, *(a[1] for a in args))
    # fp32: summation order (and silu's exp) only; bf16: the rounded
    # intermediate may flip by one step, then one rounding of the output
    rtol = 1e-5 if dtype == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err
    assert torch.equal(_bits(tq.fused_mlp_stacked(x, *args, 1)), _bits(got))  # same bits again
    if dtype == "bfloat16":
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        ks_gu = tq.mma_plan(M, D, F // tq.MLP_BLOCK_F, sms)
        ks_down = tq.mma_plan(M, F, -(-D // tq.MMA_BLOCK_N), sms)
        tiled = tq.fused_mlp_tiled_plain(x, *(a[1] for a in args), ks_gu, ks_down)
        err = (got.float() - tiled.float()).abs().max().item()
        assert err <= rtol * want.float().abs().max().item(), err
    # the dispatcher takes the kernel for stacked handles at decode M
    h_gu = {"q8": args[0], "scale": args[1], "layer": 1}
    h_down = {"q8": args[2], "scale": args[3], "layer": 1}
    assert torch.equal(tq.fused_mlp(x, h_gu, h_down), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False])
def test_qdot_gradient_through_kernel_on_card(cuda_device, dtype, stacked):
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(31)
    dt = getattr(torch, dtype)
    q = _quantized(rng, (2, 96, 200) if stacked else (96, 200))
    w = {k: v.to(cuda_device) for k, v in q.items()}
    if stacked:
        w["layer"] = 1
    x = _t(rng.normal(size=(2, 3, 96)).astype(np.float32)).to(cuda_device, dt).requires_grad_(True)
    g = _t(rng.normal(size=(2, 3, 200)).astype(np.float32)).to(cuda_device, dt)
    before = tq.LAUNCHES["int8_matmul"]
    out = tq.qdot(x, w)
    assert type(out.grad_fn).__name__ != "NoneType"
    (out.float() * g.float()).sum().backward()
    assert tq.LAUNCHES["int8_matmul"] == before + 1
    deq = tq.dequantize(w)
    want = (g.float().reshape(-1, 200) @ deq.t()).to(dt).reshape(x.shape)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    err = (x.grad.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_w8a8_prefill_launches_on_card(cuda_device):
    """An ``a8`` handle: decode M takes the weight-only kernel (the marker is
    inert), M >= 256 quantizes the rows and launches ``w8a8_matmul``; without
    the marker M >= 256 launches no ``w8a8_matmul``."""
    from mimic_tpu_torch.ops import quant as tq

    wf = torch.randn(64, 200, device=cuda_device)
    w = tq.quantize_weight(wf, act_quant=True)
    tq.reset_launch_counts()
    tq.qdot(torch.randn(8, 64, device=cuda_device), w)
    assert tq.LAUNCHES == {"int8_matmul": 1, "fused_mlp_int8": 0, "w8a8_matmul": 0}
    x = torch.randn(256, 64, device=cuda_device)
    out = tq.qdot(x, w)
    assert tq.LAUNCHES == {"int8_matmul": 1, "fused_mlp_int8": 0, "w8a8_matmul": 1}
    x8, xs = tq.quantize_rows(x)
    want = tq.w8a8_matmul_plain(x8, xs, w["q8"][:, :200], w["scale"], torch.float32)
    assert out.shape == (256, 200) and torch.equal(out, want)
    # not bit-parity with the weight-only product, but close: rows round to 1/254
    assert (out - x @ tq.dequantize(w)).abs().max() <= 0.05 * (x @ wf).abs().max()
    tq.qdot(x, {k: v for k, v in w.items() if k != "a8"})
    assert tq.LAUNCHES["w8a8_matmul"] == 1


W8A8_SHAPES = [
    # M, K, N, layers, layer
    (128, 64, 128, 0, 0),        # one tile
    (256, 256, 384, 0, 0),       # the JAX test's shape
    (1000, 512, 640, 3, 2),      # ragged last row tile, stacked
    (257, 80, 144, 0, 0),        # K and N below a tile, one row into the third row tile
    (300, 1024, 4096, 2, 1),     # many K tiles
    # the wgmma kernel's edges: one row, the last row of a 256-row tile, exactly one
    # tile, a ragged 1000 at the model's K, eight tiles of the prefill; K 80 stacked
    (1, 4096, 256, 2, 1),
    (255, 512, 384, 0, 0),
    (256, 4096, 640, 2, 1),
    (1000, 4096, 384, 0, 0),
    (2048, 4096, 512, 2, 1),
    (384, 80, 256, 3, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,layers,layer", W8A8_SHAPES)
def test_w8a8_matmul_equals_plain_on_card(cuda_device, M, K, N, layers, layer, out_dtype):
    """The int32 sum is exact in any order and the epilogue has no addition, so
    kernel and plain version agree bit for bit in fp32 and in bf16."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(40)
    dt = getattr(torch, out_dtype)
    shape = (layers, K, N) if layers else (K, N)
    wq = _t(rng.integers(-127, 128, size=shape, dtype=np.int8)).to(cuda_device)
    scale = _t(rng.uniform(1e-4, 1e-2, size=shape[:-2] + (N,)).astype(np.float32)).to(cuda_device)
    x = _t((rng.normal(size=(M, K)) * rng.uniform(0.1, 5, size=(M, 1))).astype(np.float32))
    x8, xs = tq.quantize_rows(x.to(cuda_device))
    before = tq.LAUNCHES["w8a8_matmul"]
    if layers:
        got = tq.w8a8_matmul_stacked(x8, xs, wq, scale, layer, out_dtype=dt)
        want = tq.w8a8_matmul_plain(x8, xs, wq[layer], scale[layer], dt)
    else:
        got = tq.w8a8_matmul(x8, xs, wq, scale, out_dtype=dt)
        want = tq.w8a8_matmul_plain(x8, xs, wq, scale, dt)
    torch.cuda.synchronize()
    assert tq.LAUNCHES["w8a8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (M, N) and torch.equal(got, want)
    # extreme values: every product at +-127 * 127, the largest sums K allows
    x8.fill_(127)
    wq.fill_(-127)
    w2, s2 = (wq[layer], scale[layer]) if layers else (wq, scale)
    got = tq.w8a8_matmul(x8, xs, w2.contiguous(), s2.contiguous(), out_dtype=dt)
    assert torch.equal(got, tq.w8a8_matmul_plain(x8, xs, w2, s2, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_on_card_matches_cpu(cuda_device, dtype):
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(41)
    x = _t((rng.normal(size=(512, 4096)) * rng.uniform(0.01, 30, size=(512, 1))).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    x[7] = 0
    x8, xs = tq.quantize_rows(x.to(cuda_device))
    c8, cs = tq.quantize_rows(x)
    assert torch.equal(x8.cpu(), c8) and torch.equal(xs.cpu(), cs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [80, 4096, 14336, 30000])
def test_quantize_rows_kernel_matches_cpu_on_card(cuda_device, K, dtype):
    """The one-pass kernel (one launch per call) against the plain version on the
    CPU, bit for bit: zero rows, a row under the 1e-8 floor, rows of every scale;
    K 30000 is longer than the rows the kernel keeps in shared memory."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(K)
    x = _t((rng.normal(size=(300, K)) * rng.uniform(0.01, 30, size=(300, 1))).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    x[0] = 0
    x[9] = 1e-12
    before = tq.ROW_LAUNCHES["quantize_rows"]
    x8, xs = tq.quantize_rows(x.to(cuda_device))
    torch.cuda.synchronize()
    assert tq.ROW_LAUNCHES["quantize_rows"] == before + 1
    c8, cs = tq.quantize_rows(x)
    assert x8.dtype == torch.int8 and xs.dtype == torch.float32
    assert torch.equal(x8.cpu(), c8) and torch.equal(xs.cpu(), cs)
    # leading axes, and rows of K - 3 elements (not whole 16-byte vectors: the scalar path)
    y = x.reshape(3, 100, K)[:, 1:, :K - 3]
    y8, ys = tq.quantize_rows(y.to(cuda_device))
    z8, zs = tq.quantize_rows(y)
    assert y8.shape == (3, 99, K - 3) and torch.equal(y8.cpu(), z8) and torch.equal(ys.cpu(), zs)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_lane_padded_n_through_qdot_on_card(cuda_device, out_dtype):
    """A handle stored 128-padded on N (300 real columns) through qdot's a8 branch:
    the output sliced back, equal to the plain version on the real columns."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(44)
    w = tq.quantize_weight(_t(rng.normal(size=(256, 300)).astype(np.float32)).to(cuda_device),
                           act_quant=True)
    assert w["q8"].shape == (256, 384)
    x = _t(rng.normal(size=(512, 256)).astype(np.float32)).to(cuda_device)
    dt = getattr(torch, out_dtype)
    out = tq.qdot(x, w, preferred_element_type=dt)
    x8, xs = tq.quantize_rows(x)
    assert out.shape == (512, 300)
    assert torch.equal(out, tq.w8a8_matmul_plain(x8, xs, w["q8"][:, :300], w["scale"], dt))


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_w8a8_qdot_gradient_on_card(cuda_device, stacked):
    """The W8A8 forward carries a grad_fn and the straight-through backward
    ``dY @ deq(W)T``; a pad_k handle pads the activations first."""
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(42)
    shape = (2, 96, 200) if stacked else (96, 200)
    w = tq.quantize_weight(_t(rng.normal(size=shape).astype(np.float32)).to(cuda_device),
                           act_quant=True, pad_k=True)
    if stacked:
        w["layer"] = 1
    x = _t(rng.normal(size=(2, 150, 96)).astype(np.float32)).to(cuda_device).requires_grad_(True)
    g = _t(rng.normal(size=(2, 150, 200)).astype(np.float32)).to(cuda_device)
    before = tq.LAUNCHES["w8a8_matmul"]
    out = tq.qdot(x, w)
    assert tq.LAUNCHES["w8a8_matmul"] == before + 1 and out.shape == (2, 150, 200)
    assert out.grad_fn is not None
    (out * g).sum().backward()
    want = (g.reshape(-1, 200) @ tq.dequantize(w).t())[:, :96].reshape(x.shape)
    assert (x.grad - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_w8a8_wrapper_raises_on_bad_cuda_inputs(cuda_device):
    from mimic_tpu_torch.ops import quant as tq

    x8 = torch.zeros(32, 64, dtype=torch.int8, device=cuda_device)
    xs = torch.ones(32, device=cuda_device)
    wq = torch.zeros(64, 128, dtype=torch.int8, device=cuda_device)
    sw = torch.ones(128, device=cuda_device)
    tq.w8a8_matmul(x8, xs, wq, sw)
    with pytest.raises(TypeError):
        tq.w8a8_matmul(x8.float(), xs, wq, sw)
    with pytest.raises(ValueError):
        tq.w8a8_matmul(x8, xs, wq[:, :100].contiguous(), sw[:100].contiguous())  # N % 16
    with pytest.raises(ValueError):
        tq.w8a8_matmul(x8, xs, wq.t(), sw)  # not contiguous, wrong K
    with pytest.raises(ValueError):
        tq.w8a8_matmul(x8, xs, wq.cpu(), sw)
    with pytest.raises(ValueError):
        tq.w8a8_matmul_stacked(x8, xs, wq[None].contiguous(), sw[None].contiguous(), 1)
    with pytest.raises(TypeError):
        tq.w8a8_matmul(x8, xs, wq, sw, out_dtype=torch.float16)


def test_w8a8_cpu_path_never_launches_or_builds(monkeypatch):
    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.ops import quant as tq

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    # earlier cuda-marked tests may have loaded the library: fail on any use of it
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    rng = np.random.default_rng(43)
    rows_before = dict(tq.ROW_LAUNCHES)
    x8, xs = tq.quantize_rows(_t(rng.normal(size=(300, 64)).astype(np.float32)))
    wq = _t(rng.integers(-127, 128, size=(2, 64, 128), dtype=np.int8))
    sw = _t(rng.uniform(1e-3, 1e-2, size=(2, 128)).astype(np.float32))
    before = dict(tq.LAUNCHES)
    a = tq.w8a8_matmul(x8, xs, wq[1], sw[1], out_dtype=torch.float32)
    b = tq.w8a8_matmul_stacked(x8, xs, wq, sw, 1, out_dtype=torch.float32)
    assert torch.equal(a, b) and tq.LAUNCHES == before and tq.ROW_LAUNCHES == rows_before
    # the exact integer sum, scaled in the kernel's order
    acc = x8.to(torch.int64) @ wq[1].to(torch.int64)
    assert torch.equal(a, (acc.float() * xs[:, None]) * sw[1][None, :])
    with pytest.raises(ValueError):
        tq.w8a8_matmul(x8.to("meta"), xs, wq[1], sw[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pads", [(40, 0), (130, 5)])  # (130: a fully masked first chunk)
def test_prompt_attention_int8_matches_plain_on_card(cuda_device, dtype, pads):
    from mimic_tpu_torch.ops import decode_attention as tda

    B0, Kb, Hkv, G, D, Sp, L = 2, 3, 2, 4, 128, 384, 2
    rng = np.random.default_rng(32)
    dt = getattr(torch, dtype)
    pk, pv = tda.quantize_prompt_kv(
        *(_t(rng.normal(size=(L, B0, Sp, Hkv, D)).astype(np.float32)).to(cuda_device)
          for _ in range(2)))
    qg = _t(rng.normal(size=(B0 * Kb, 1, Hkv, G, D)).astype(np.float32) / np.sqrt(D))
    qg = qg.to(cuda_device, dt)
    mask = np.ones((B0, Sp), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    mask = _t(mask).to(cuda_device)
    before = tda.LAUNCHES["prompt_attn_int8"]
    o, m, l = tda.prompt_attention_int8(qg, dict(pk, layer=1), dict(pv, layer=1), mask)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["prompt_attn_int8"] == before + 1
    assert o.shape == (B0 * Kb, Hkv, G, 1, D) and m.shape == l.shape == (B0 * Kb, Hkv, G, 1)
    qf = tda._fold(qg, B0).contiguous()
    want = [tda._unfold(t, B0 * Kb, G) for t in tda.prompt_attention_int8_plain(
        qf, pk["q8"][1], pk["scale"][1], pv["q8"][1], pv["scale"][1], mask)]
    # m: fp32 scores of identical inputs; o and l: fp32 sums (bf16: p·vscale
    # rounded against the chunk's max rather than the row's, 2^-8 relative)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    assert (m - want[1]).abs().max().item() <= 1e-3
    for a, b in ((o, want[0]), (l, want[2])):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= rtol * b.abs().max().item()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 200), (3, 64, 200)], ids=["2d", "stacked"])
def test_quantization_on_card_gives_the_cpu_bytes(cuda_device, shape):
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(33)
    w = _t(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    want, got = tq.quantize_weight(w), tq.quantize_weight(w.to(cuda_device))
    for key in ("q8", "scale"):
        assert torch.equal(_bits(got[key]), _bits(want[key])), key
    kv = _t(rng.normal(size=(2, 1, 200, 2, 128)).astype(np.float32)).to(torch.bfloat16)
    cpu_kv = tda.quantize_prompt_kv(kv, kv, padded_len=256)
    card_kv = tda.quantize_prompt_kv(kv.to(cuda_device), kv.to(cuda_device), padded_len=256)
    for a, b in zip(card_kv, cpu_kv):
        for key in ("q8", "scale"):
            assert torch.equal(_bits(a[key]), _bits(b[key])), key


def _prompt_inputs(cuda_device, dtype, B0=2, Hkv=2, M=12, Sp=1024, pads=(300, 0), seed=34):
    from mimic_tpu_torch.ops import decode_attention as tda

    rng = np.random.default_rng(seed)
    pk, pv = tda.quantize_prompt_kv(
        *(_t(rng.normal(size=(1, B0, Sp, Hkv, 128)).astype(np.float32)).to(cuda_device)
          for _ in range(2)))
    qf = _t((rng.normal(size=(B0, Hkv, M, 128)) / np.sqrt(128)).astype(np.float32))
    mask = np.ones((B0, Sp), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    return (qf.to(cuda_device, getattr(torch, dtype)), pk["q8"][0], pk["scale"][0], pv["q8"][0],
            pv["scale"][0], _t(mask).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
def test_prompt_attention_int8_every_split_on_card(cuda_device, split):
    """The bf16 kernel under each cluster split (8 chunks: 1 to 8 per rank), a
    fully masked leading chunk: o and l within 1e-2 of max |plain| and m within
    1e-3 of the plain version and of the tiled plain version that follows the
    same split (p·vscale rounded to bf16 against a running max), and a second
    launch bit-identical."""
    from mimic_tpu_torch.ops import decode_attention as tda

    args = _prompt_inputs(cuda_device, "bfloat16")
    got = tda._launch(*args, split=split)
    again = tda._launch(*args, split=split)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = tda.prompt_attention_int8_plain(*args)
    tiled = tda.prompt_attention_int8_tiled_plain(*(a.cpu() for a in args), split)
    o, m, l = got
    assert (m - want[1]).abs().max().item() <= 1e-3
    assert (m.cpu() - tiled[1]).abs().max().item() <= 1e-3
    for a, b in ((o, want[0]), (l, want[2])):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-2 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prompt_attention_int8_kernels_per_call_on_card(cuda_device, dtype):
    """bf16: one launch of the tensor-core kernel per call; fp32: the scalar chunk
    kernel and its merge, within 1e-5 of the plain version."""
    from torch.profiler import ProfilerActivity, profile

    from mimic_tpu_torch.ops import decode_attention as tda

    args = _prompt_inputs(cuda_device, dtype, M=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tda._launch(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if dtype == "bfloat16":
        assert len(names) == 1 and "prompt_attn_mma_kernel" in names[0], names
    else:
        assert len(names) == 2 and "prompt_attn_kernel" in names[0], names
        assert "prompt_attn_merge" in names[1], names
    want = tda.prompt_attention_int8_plain(*args)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert (got[1] - want[1]).abs().max().item() <= (1e-5 if dtype == "float32" else 1e-3)
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()


# ---------------------------------------------------------------------------
# ops.norms: the row-norm kernel (LayerNorm and RMSNorm) against its plain version
# ---------------------------------------------------------------------------


def _norm_inputs(norm, M, D, dtype, device, seed, w_dtype=None):
    """Rows of every scale around an offset (the LayerNorm's mean), weights
    near 1 and a small bias; fp32 numbers rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, D)) * rng.uniform(0.1, 10, size=(M, 1)) + rng.normal(size=(M, 1))
    w = 1 + 0.1 * rng.normal(size=D)
    b = 0.1 * rng.normal(size=D) if norm == "layer_norm" else None
    w_dtype = w_dtype or dtype
    return (_t(x.astype(np.float32)).to(device, dtype),
            _t(w.astype(np.float32)).to(device, w_dtype),
            None if b is None else _t(b.astype(np.float32)).to(device, w_dtype))


def _norm_call(norm, fn_name, x, w, b, eps=1e-6):
    from mimic_tpu_torch.ops import norms as tn

    fn = getattr(tn, norm + fn_name)
    return fn(x, w, eps) if norm == "rms_norm" else fn(x, w, b, eps)


def _bf16_ulps(got, want):
    """|got - want| in units of bf16's spacing at max(|want|, 2^-10).  The kernel
    and the plain version round the same fp32 steps, their sums taken in another
    order: the fp32 results differ by ~1e-7 of an O(1) output, under one
    rounding to bf16.  Nearer 0 than 2^-10, where ``n·w + b`` cancels, the
    spacing at 2^-10 (2^-17) stands for the outputs' scale."""
    g, w = got.float(), want.float()
    at = torch.clamp(w.abs(), min=2.0 ** -10)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(at)) - 7)


def _check_norm(norm, x, w, b):
    """The kernel against the plain version on the same card inputs: bf16 within
    one ulp (the share of bit-equal elements printed), fp32 within 1e-5 of max
    |plain|; returns that share."""
    got = _norm_call(norm, "", x, w, b)
    want = _norm_call(norm, "_plain", x, w, b)
    assert got.dtype == x.dtype and got.shape == x.shape and torch.isfinite(got).all()
    equal = (got == want).float().mean().item()
    if x.dtype == torch.bfloat16:
        assert _bf16_ulps(got, want).max().item() <= 1
    else:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    print(f"row_norm {norm} {tuple(x.shape)} {x.dtype}: {equal:.4%} of the elements bit-equal "
          f"to the plain version")
    return equal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16, 32, 96, 144, 1024, 1152, 1280, 4096])
@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_row_norm_matches_plain_on_card(cuda_device, norm, D, dtype):
    """Every width of the vision towers and connectors (SigLIP 1152, CLIP-L 1024,
    CLIP-H 1280, the idefics2 connector 4096, the idefics-9b resampler's head dim
    96) and the tiny towers' (8-144), at ragged row counts: one row, fewer rows
    than a CTA holds, and rows that leave the last CTA part empty."""
    dt = getattr(torch, dtype)
    for M in (1, 3, 37, 1000):
        x, w, b = _norm_inputs(norm, M, D, dt, cuda_device, seed=D + M)
        _check_norm(norm, x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("norm,shape", [("layer_norm", (20, 4992, 1152)),
                                        ("rms_norm", (20, 4900, 4096))],
                         ids=["siglip", "connector"])
def test_row_norm_at_the_train_cells_shapes_on_card(cuda_device, norm, shape):
    """The idefics2-8b train step's tower rows (20 images × 4992 padded patches
    × 1152: 99,840 rows) and its connector's context (20 × 4900 × 4096), bf16,
    through the wrapper as ``models/vision.py`` calls it."""
    x, w, b = _norm_inputs(norm, shape[0] * shape[1], shape[2], torch.bfloat16, cuda_device,
                           seed=7)
    assert _check_norm(norm, x.reshape(shape), w, b) > 0.5


@pytest.mark.cuda
def test_row_norm_variants_on_card(cuda_device):
    """LayerNorm without a bias, fp32 weights beside bf16 rows and bf16 weights
    beside fp32 rows, a 2-D and a 4-D input (the resampler's per-head q/k norms
    [B, N, H, 96]), a constant row (variance 0: eps alone), and no rows (no
    launch)."""
    from mimic_tpu_torch.ops import norms as tn

    x, w, _ = _norm_inputs("layer_norm", 300, 1152, torch.bfloat16, cuda_device, seed=1)
    _check_norm("layer_norm", x, w, None)
    for dt, wdt in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        for norm in ("layer_norm", "rms_norm"):
            _check_norm(norm, *_norm_inputs(norm, 300, 1280, dt, cuda_device, seed=2, w_dtype=wdt))
    x, w, b = _norm_inputs("layer_norm", 2 * 64 * 16, 96, torch.bfloat16, cuda_device, seed=3)
    _check_norm("layer_norm", x.reshape(2, 64, 16, 96), w, b)
    x[5] = 3.0
    _check_norm("layer_norm", x, w, b)
    before = dict(tn.LAUNCHES)
    assert tn.rms_norm(x[:0], w, 1e-6).shape == (0, 96) and tn.LAUNCHES == before


@pytest.mark.cuda
def test_row_norm_raises_on_what_it_does_not_take_on_card(cuda_device):
    from mimic_tpu_torch.ops import norms as tn

    x, w, b = _norm_inputs("layer_norm", 64, 1152, torch.bfloat16, cuda_device, seed=4)
    with pytest.raises(ValueError, match="no backward"):
        tn.layer_norm(x.clone().requires_grad_(True), w, b, 1e-6)
    with pytest.raises(ValueError, match="no backward"):
        tn.rms_norm(x, w.clone().requires_grad_(True), 1e-6)
    with torch.no_grad():  # outside grad mode the kernel takes it
        tn.layer_norm(x, w.clone().requires_grad_(True), b, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        tn.layer_norm(x.t(), w[:64].contiguous(), b[:64].contiguous(), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        tn.rms_norm(x.reshape(2, 32, 1152)[:, :20], w, 1e-6)
    for D, dt in ((12, torch.bfloat16), (8200, torch.bfloat16), (4100, torch.float32),
                  (6, torch.float32)):
        with pytest.raises(ValueError, match="no kernel for width"):
            tn.rms_norm(torch.ones(4, D, dtype=dt, device=cuda_device),
                        torch.ones(D, dtype=dt, device=cuda_device), 1e-6)
    with pytest.raises(TypeError):
        tn.rms_norm(x.half(), w, 1e-6)
    with pytest.raises(ValueError):
        tn.layer_norm(x, w[:1024].contiguous(), b, 1e-6)
    with pytest.raises(ValueError):
        tn.layer_norm(x, w.cpu(), b, 1e-6)
    assert tn.kernel_plan(1152, torch.bfloat16) == (32, 5)
    assert tn.kernel_plan(4096, torch.bfloat16) == (32, 16)
    assert tn.kernel_plan(96, torch.bfloat16) == (16, 1)


@pytest.mark.cuda
def test_row_norm_launches_are_counted_on_card(cuda_device):
    from mimic_tpu_torch.ops import norms as tn
    from mimic_tpu_torch.utils import tracing

    x, w, b = _norm_inputs("layer_norm", 100, 1152, torch.bfloat16, cuda_device, seed=5)
    tn.reset_launch_counts()
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        tn.layer_norm(x, w, b, 1e-6)
        tn.layer_norm(x, w, b, 1e-6)
        tn.rms_norm(x, w, 1e-6)
        torch.cuda.synchronize()
    assert tn.LAUNCHES == {"layer_norm": 2, "rms_norm": 1}
    assert tracing.recorded()["counts"]["norm_kernel_launches"] == 3
    tn.rms_norm(x, w, 1e-6)  # outside a profile: counted by LAUNCHES alone
    assert tn.LAUNCHES["rms_norm"] == 2
    tracing.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["idefics2", "idefics1", "llava-interleave"])
def test_towers_through_the_norm_kernel_on_card(cuda_device, family, monkeypatch):
    """A tiny tower and its connector in bf16 on the card (the flash path, two
    images of 70 px), through the kernel and through the plain norms: the
    launches a call (two a layer, the pre- and post-LN where the config has
    them; the connector's norms), and the features within bf16 tolerance."""
    import dataclasses

    from mimic_tpu_torch.models import lvlm as tlvlm
    from mimic_tpu_torch.models import vision as tv
    from mimic_tpu_torch.models.config import get_model_config
    from mimic_tpu_torch.ops import norms as tn

    cfg = get_model_config(f"tiny-{family}")
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, image_size=70, num_heads=2,
                                                 hidden_size=144))
    params = tlvlm.init_lvlm_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                    cuda_device, torch.bfloat16)
    pixels = _t(np.random.default_rng(6).normal(size=(1, 2, 70, 70, 3)).astype(np.float32))
    pixels = pixels.to(cuda_device)
    tn.reset_launch_counts()
    with torch.no_grad():
        got = tlvlm.encode_images(params, cfg, pixels, attn_impl="flash")
    L, P = cfg.vision.num_layers, cfg.perceiver.num_layers if cfg.perceiver else 0
    ln = 2 * L + int(cfg.vision.use_class_token) + int(cfg.vision.post_layernorm)
    want_launches = {"idefics2": {"layer_norm": ln, "rms_norm": 3 * P + 1},
                     "idefics1": {"layer_norm": ln + 5 * P + 1, "rms_norm": 0},
                     "llava-interleave": {"layer_norm": ln, "rms_norm": 0}}[family]
    assert tn.LAUNCHES == want_launches
    monkeypatch.setattr(tv, "layer_norm", tn.layer_norm_plain)
    monkeypatch.setattr(tv, "rms_norm", tn.rms_norm_plain)
    with torch.no_grad():
        want = tlvlm.encode_images(params, cfg, pixels, attn_impl="flash")
    assert tn.LAUNCHES == want_launches
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
