"""mimic_tpu_torch.ops.norms on the CPU, and the vision tower's route to it.

- ``layer_norm`` / ``rms_norm`` on CPU tensors take the plain versions: bit for
  bit the functions ``models/layers.py`` held before the kernel (copied below
  as they were), and within fp32 summation order (1e-5) of the JAX package's;
- ``models/vision.py`` calls the kernel's wrappers only where no gradient is
  needed (the towers and connectors are frozen), and the plain, differentiable
  functions where autograd records the call: gradients through ``vit_forward``
  and ``perceiver_forward`` are those of the plain functions, bit for bit;
- importing ``ops/norms.py`` and running it on the CPU builds nothing.

The kernel itself runs only on a card: ``tests/test_torch_kernels.py``.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import layers as jl
from mimic_tpu_torch.models import layers as tl
from mimic_tpu_torch.models import vision as tv
from mimic_tpu_torch.models.config import get_model_config
from mimic_tpu_torch.models.lvlm import init_lvlm_params
from mimic_tpu_torch.ops import norms


# models/layers.py's two norms before ops/norms.py, as they were
def _old_rms_norm(x, weight, eps):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def _old_layer_norm(x, weight, bias, eps):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


NORMS = ["layer_norm", "layer_norm_no_bias", "rms_norm"]
# a tiny tower, the idefics-9b resampler's head dim, SigLIP's width, the connector's
WIDTHS = [16, 96, 1152, 4096]


def _inputs(norm, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 7, D)) * rng.uniform(0.1, 10, size=(3, 7, 1)) + rng.normal(size=(3, 7, 1))
    w = 1 + 0.1 * rng.normal(size=D)
    b = None if norm != "layer_norm" else 0.1 * rng.normal(size=D)
    return tuple(None if a is None else torch.from_numpy(a.astype(np.float32)).to(dtype)
                 for a in (x, w, b))


def _call(fns, norm, x, w, b, eps=1e-6):
    ln, rms = fns
    return rms(x, w, eps) if norm == "rms_norm" else ln(x, w, b, eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("norm", NORMS)
def test_cpu_norms_are_the_old_functions_bit_for_bit(norm, D, dtype):
    x, w, b = _inputs(norm, D, dtype)
    want = _call((_old_layer_norm, _old_rms_norm), norm, x, w, b)
    for fns in ((norms.layer_norm, norms.rms_norm), (tl.layer_norm, tl.rms_norm)):
        got = _call(fns, norm, x, w, b)
        assert got.dtype == dtype and torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                                           else torch.int32),
                                                  want.view(torch.int16 if dtype == torch.bfloat16
                                                            else torch.int32))


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("norm", NORMS)
def test_cpu_norms_match_jax_in_fp32(norm, D):
    x, w, b = _inputs(norm, D, torch.float32, seed=1)
    got = _call((norms.layer_norm, norms.rms_norm), norm, x, w, b)
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(w.numpy())
    jb = None if b is None else jnp.asarray(b.numpy())
    want = jl.rms_norm(jx, jw, 1e-6) if norm == "rms_norm" else jl.layer_norm(jx, jw, jb, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_layers_exports_the_plain_versions():
    assert tl.layer_norm is norms.layer_norm_plain and tl.rms_norm is norms.rms_norm_plain


def test_needs_grad_follows_grad_mode_and_requires_grad():
    x, w = torch.ones(2, 8), torch.ones(8)
    assert not norms.needs_grad(x, w, None)
    w.requires_grad_(True)
    assert norms.needs_grad(x, w, None)
    with torch.no_grad():
        assert not norms.needs_grad(x, w, None)
    with torch.inference_mode():
        assert not norms.needs_grad(x.clone(), None)


def test_cpu_path_never_builds_or_counts(monkeypatch):
    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.utils import tracing

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = dict(norms.LAUNCHES)
    tracing.reset()
    x, w, b = _inputs("layer_norm", 32, torch.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        norms.layer_norm(x, w, b, 1e-6)
        norms.rms_norm(x, w, 1e-6)
    assert norms.LAUNCHES == before and "norm_kernel_launches" not in tracing.recorded()["counts"]
    with pytest.raises(ValueError):
        norms.layer_norm(x.to("meta"), w, b, 1e-6)
    with pytest.raises(ValueError):
        norms.rms_norm(x.to("meta"), w, 1e-6)


def test_import_builds_nothing_without_nvcc():
    code = (
        "import os, subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import mimic_tpu_torch.ops.norms as n, mimic_tpu_torch.ops._build as b\n"
        "import mimic_tpu_torch.models.vision\n"
        "import torch\n"
        "y = n.rms_norm(torch.ones(4, 16), torch.ones(16), 1e-6)\n"
        "assert not calls and b._lib is None, calls\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in __import__("os").environ.items() if k != "CUDA_HOME"}
    env["PATH"] = "/nonexistent"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# models/vision.py: the kernel's wrappers where no gradient is needed
# ---------------------------------------------------------------------------


def _tower(family, flash_pad=False):
    cfg = get_model_config(f"tiny-{family}")
    if flash_pad:  # 70 px / patch 14: 25 patches, padded to 128 keys on the flash path
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, image_size=70))
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    size = cfg.vision.image_size
    pixels = torch.from_numpy(rng.normal(size=(2, size, size, 3)).astype(np.float32))
    return cfg, params, pixels


@pytest.fixture
def spies(monkeypatch):
    """Counts of the calls that reach ``ops.norms.layer_norm`` / ``rms_norm``
    (the kernel's wrappers; on the CPU they run the plain versions)."""
    calls = {"layer_norm": 0, "rms_norm": 0}

    def spy(name):
        real = getattr(norms, name)

        def wrapped(*args):
            calls[name] += 1
            return real(*args)
        return wrapped

    for name in calls:
        monkeypatch.setattr(norms, name, spy(name))
    return calls


# (family, layer_norm calls of vit_forward: two a layer, the class-token tower's
# pre-LN, the post-LN where the config has one)
VIT_CALLS = [("idefics2", lambda L: 2 * L + 1), ("idefics1", lambda L: 2 * L + 2),
             ("llava-interleave", lambda L: 2 * L)]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("family,calls", VIT_CALLS, ids=[f for f, _ in VIT_CALLS])
def test_vit_forward_takes_the_kernel_route_without_grad(spies, family, calls, attn_impl):
    cfg, params, pixels = _tower(family, flash_pad=attn_impl == "flash")
    out = tv.vit_forward(params["vision"], cfg.vision, pixels, attn_impl=attn_impl)
    assert spies == {"layer_norm": calls(cfg.vision.num_layers), "rms_norm": 0}
    assert out.is_contiguous()
    spies["layer_norm"] = 0
    with torch.no_grad():
        tv.vit_forward(params["vision"], cfg.vision, pixels.requires_grad_(True),
                       attn_impl=attn_impl)
    assert spies["layer_norm"] == calls(cfg.vision.num_layers)


@pytest.mark.parametrize("family", ["idefics2", "idefics1"])
def test_connectors_take_the_kernel_route_without_grad(spies, family):
    cfg, params, _ = _tower(family)
    L, width = cfg.perceiver.num_layers, cfg.vision.hidden_size
    feats = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 4, width)).astype(np.float32))
    key = "connector" if family == "idefics2" else "perceiver"
    tv.perceiver_forward(params[key], cfg.perceiver, feats)
    # idefics2: latents and context, post-LN, a layer, and the final norm (RMSNorm);
    # idefics1: context, latents, q, k and the MLP's, a layer, and the final (LayerNorm)
    want = ({"layer_norm": 0, "rms_norm": 3 * L + 1} if family == "idefics2"
            else {"layer_norm": 5 * L + 1, "rms_norm": 0})
    assert spies == want


@pytest.mark.parametrize("what", ["pixels", "weights"])
@pytest.mark.parametrize("family", ["idefics2", "idefics1", "llava-interleave"])
def test_vit_forward_with_grad_takes_the_plain_route_and_keeps_its_gradients(
        spies, monkeypatch, family, what):
    cfg, params, pixels = _tower(family, flash_pad=True)
    vp = params["vision"]
    leaves = [pixels] if what == "pixels" else [vp["layers"]["ln1_w"], vp["layers"]["ln2_b"]]
    for t in leaves:
        t.requires_grad_(True)

    def grads():
        out = tv.vit_forward(vp, cfg.vision, pixels, attn_impl="flash")
        return torch.autograd.grad((out * out).sum(), leaves)

    got = grads()
    # with the layer norms' weights alone requiring grad, the class-token tower's
    # pre-LN (before any of them) still needs none and takes the kernel route
    pre_ln = int(what == "weights" and cfg.vision.use_class_token)
    assert spies == {"layer_norm": pre_ln, "rms_norm": 0}
    # the same tower with the norms models/layers.py held before
    monkeypatch.setattr(tv, "layer_norm", _old_layer_norm)
    want = grads()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_perceiver_with_grad_takes_the_plain_route_and_keeps_its_gradients(spies, monkeypatch):
    cfg, params, _ = _tower("idefics2")
    width = cfg.vision.hidden_size
    feats = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 4, width)).astype(np.float32))
    feats.requires_grad_(True)

    def grads():
        out = tv.perceiver_forward(params["connector"], cfg.perceiver, feats)
        return torch.autograd.grad((out * out).sum(), feats)[0]

    got = grads()
    # layer 0's norm of the latents comes before they meet the features: no gradient
    assert spies == {"layer_norm": 0, "rms_norm": 1}
    monkeypatch.setattr(tv, "rms_norm", _old_rms_norm)
    assert torch.equal(got, grads())
