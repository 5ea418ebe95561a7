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


def make_inputs(B=2, T=128, S=128, H=4, Hkv=2, D=32, seed=0, left_pad=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    km = np.ones((B, S), np.int32)
    km[0, S - S // 5:] = 0       # suffix padding
    km[-1, 40:44] = 0            # interior PAD separator
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
    # (kernel, B, T, S, H, Hkv, D, causal, need_unmasked, left_pad)
    ("onepass_fwd", 1, 256, 640, 4, 4, 72, False, False, 0),
    ("onepass_fwd", 2, 256, 256, 8, 2, 128, True, True, 20),
    ("flash_fwd", 1, 640, 640, 8, 2, 128, True, True, 20),
    ("flash_fwd", 2, 1000, 1000, 4, 4, 72, False, True, 0),
    ("flash_fwd", 2, 300, 300, 8, 2, 128, True, False, 10),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    name, B, T, S, H, Hkv, D, causal, need_unmasked, left_pad = case
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=D, left_pad=left_pad, seed=T)
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


# (B, T, S, H, Hkv, causal, need_unmasked, left_pad); head dim 128
BWD_CASES = [
    (2, 256, 256, 8, 2, True, True, 37),
    (1, 640, 640, 4, 1, True, True, 0),
    (2, 300, 300, 8, 2, True, False, 20),
    (2, 200, 200, 4, 4, False, True, 0),
    (1, 130, 130, 4, 2, False, False, 0),
]


def _bwd_inputs(case, dtype, dev, seed):
    B, T, S, H, Hkv, causal, need_unmasked, left_pad = case
    q, k, v, km = make_inputs(B=B, T=T, S=S, H=H, Hkv=Hkv, D=128, left_pad=left_pad, seed=seed)
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
    before = dict(tfb.LAUNCHES)
    got = tfb.flash_attention_backward(q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u,
                                       causal=causal, need_unmasked=need_unmasked)
    torch.cuda.synchronize()
    assert {n: tfb.LAUNCHES[n] - before[n] for n in before} == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    want = tfb.flash_attention_backward_plain(q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u,
                                              causal=causal, need_unmasked=need_unmasked)
    # fp32: summation order only; bf16: each gradient is rounded to bf16 once
    # (relative 2^-8) from fp32 sums of the same bf16 inputs
    rtol = 1e-4 if dtype == "float32" else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item(), (name, err)


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
