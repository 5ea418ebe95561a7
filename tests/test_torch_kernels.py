"""mimic_tpu_torch.ops.flash_attention without JAX: the dispatch rule, the
launch counters, the no-fallback rules and, on a CUDA card, each CUDA kernel
against its plain version in fp32 and bf16.

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
