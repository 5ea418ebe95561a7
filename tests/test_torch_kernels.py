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


def make_inputs(B=2, T=128, S=128, H=4, Hkv=2, D=32, seed=0, left_pad=0, zero_spans=None):
    """``zero_spans``: instead of the default mask, all ones but keys [a, b) of
    every row (whole key tiles without an attendable key), then ``left_pad``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
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
    # the tensor-core kernel's tiles (128 query rows per CTA, 64 per warpgroup, 64 keys):
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
@pytest.mark.parametrize("D", [64, 72, 80, 128])
def test_tiled_plain_version_walks_the_kernels_tiles_on_card(cuda_device, D):
    """attention_tiled_plain (the CPU tests' model of the bf16 forward) and the
    compiled kernel name the same tiling."""
    import ctypes

    from mimic_tpu_torch.ops import _build

    block_m, group_rows, block_n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _build.load_library().mimic_attn_fwd_tiling(
        D, ctypes.byref(block_m), ctypes.byref(group_rows), ctypes.byref(block_n))
    assert rc == 0
    assert (block_m.value, group_rows.value, block_n.value) == (
        tfa.TILE_BLOCK_M, tfa.TILE_GROUP_ROWS, tfa.TILE_BLOCK_N[D])


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
