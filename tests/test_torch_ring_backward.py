"""The backward of mimic_tpu_torch.ops.ring_attention, fp32.

- The block schedule in one process (``ring_attention_backward_chunks``,
  the schedule every rank runs with the exchange replaced by indexing):
  every rank's query chunk through ``ring_block_backward`` over every rank's
  K/V block, given the merged forward, summed, against one
  ``flash_attention_backward_plain`` call on the whole sequence within 1e-5
  (causal and not, with and without
  ``need_unmasked``, cotangents on lse and / or lse_u, GQA, left padding,
  interior pads and a row with no attendable key).  A block runs one
  backward call, n² of them with ``need_unmasked``, n(n+1)/2 without it
  under causal masking (the future blocks add exactly zero there).
- ``ring_attention_sharded`` under ``torch.autograd.grad`` on four ``gloo``
  processes (the meshes of ``tests/test_torch_ring_attention.py``) against
  ``jax.vjp`` through JAX's ``ring_attention_sharded`` on virtual devices
  with the same random cotangents on out, lse and lse_u: dq, dk and dv within
  1e-5 absolute and 1e-4 relative, equal on every rank of a ring.  The
  cotangents of out and lse are zero on rows with no attendable key, where
  the two packages' conventions differ.
- That difference: the port's kernels give such a row p = 0, so it sends v
  no gradient, as ``flash_attention_backward_plain`` on the gathered
  sequence does (held within 1e-5); JAX's ring, differentiated by autodiff,
  gives each of its keys' dv g_out / T.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mimic_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from mimic_tpu_torch.ops import ring_attention as tra
from mimic_tpu_torch.ops.flash_attention import attention_plain
from mimic_tpu_torch.ops.flash_backward import flash_attention_backward_plain
from torch_dist import run_world

TOL = 1e-5
B, T, H, HKV, D = 4, 64, 4, 2, 16
COTANGENTS = ("g_out", "g_lse", "g_lse_u")


def _inputs(causal, seed, need_unmasked=True, zero_keyless=True):
    """q/k/v, a key mask with left padding, interior pads, a row with no
    attendable key and suffix padding, and random cotangents (out's and
    lse's zero on rows with no attendable key when ``zero_keyless``)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    km = np.ones((B, T), np.int32)
    km[0, :21] = 0      # left padding across the first ring chunk
    km[1, 20:23] = 0    # interior pads
    km[2, :] = 0        # a row with no attendable key
    km[3, 50:] = 0      # suffix padding
    allowed = (km != 0)[:, None, :] & (np.tril(np.ones((T, T), bool)) if causal else True)
    keep = allowed.any(-1)[..., None] if zero_keyless else np.ones((B, T, 1), bool)
    return {
        "q": q, "k": k, "v": v, "km": km, "causal": causal, "need_unmasked": need_unmasked,
        "g_out": rng.normal(size=(B, T, H, D)).astype(np.float32) * keep[..., None],
        "g_lse": rng.normal(size=(B, T, H)).astype(np.float32) * keep,
        "g_lse_u": rng.normal(size=(B, T, H)).astype(np.float32),
    }


def _t(c, *names):
    return [torch.from_numpy(np.asarray(c[x])) for x in names]


# ---------------------------------------------------------------------------
# (i) the block schedule in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cot", ["g_lse", "g_lse_u", "both"])
@pytest.mark.parametrize("need_unmasked", [True, False], ids=["lse_u", "masked"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_block_schedule_matches_plain(monkeypatch, n, causal, need_unmasked, cot):
    c = _inputs(causal, 10 + n, zero_keyless=False)
    q, k, v, km, g_out, g_lse, g_lse_u = _t(c, "q", "k", "v", "km", *COTANGENTS)
    g_lse = g_lse if cot in ("g_lse", "both") else None
    g_lse_u = g_lse_u if cot in ("g_lse_u", "both") else None
    fwd = attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    calls = []
    real = tra.flash_attention_backward
    monkeypatch.setattr(tra, "flash_attention_backward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tra.ring_attention_backward_chunks(q, k, v, km, *fwd, g_out, g_lse, g_lse_u, n,
                                             causal=causal, need_unmasked=need_unmasked)
    want = flash_attention_backward_plain(q, k, v, km, *fwd, g_out, g_lse, g_lse_u,
                                          causal=causal, need_unmasked=need_unmasked)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL, msg=name)
    assert len(calls) == (n * (n + 1) // 2 if causal and not need_unmasked else n * n)


def test_precomputed_delta():
    """The plain backward takes Δ from the caller (the ring computes it once
    per chunk) and gives what it gives when it computes it."""
    c = _inputs(True, 40, zero_keyless=False)
    q, k, v, km, g_out, g_lse, g_lse_u = _t(c, "q", "k", "v", "km", *COTANGENTS)
    fwd = attention_plain(q, k, v, km)
    want = flash_attention_backward_plain(q, k, v, km, *fwd, g_out, g_lse, g_lse_u)
    got = flash_attention_backward_plain(q, k, v, km, *fwd, g_out, g_lse, g_lse_u,
                                         delta=(g_out * fwd[0]).sum(-1))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (ii), (iii): ring_attention_sharded's gradients on four ranks
# ---------------------------------------------------------------------------

MESHES = ["sp4", "sp2", "sp2-data"]
JAX_CASES = {  # case: (causal, need_unmasked, meshes)
    "causal": (True, True, MESHES),
    "noncausal": (False, True, MESHES),
    "causal-masked": (True, False, ["sp4"]),
}
KEYLESS_MESHES = ["sp4", "sp2"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {}
    for i, (case, (causal, need_unmasked, meshes)) in enumerate(JAX_CASES.items()):
        cases[case] = dict(_inputs(causal, 20 + i, need_unmasked), meshes=meshes)
    cases["keyless"] = dict(_inputs(True, 30, zero_keyless=False), meshes=KEYLESS_MESHES)
    outs = run_world("torch_workers:ring_backward_world", 4,
                     tmp_path_factory.mktemp("ring_bwd"), {"cases": cases})
    return cases, outs


def _rank_grads(outs, case, mesh):
    """Each rank's full-batch gradients (the data mesh: its two rows)."""
    if mesh != "sp2-data":
        return [o[(case, mesh)] for o in outs]
    return [[np.concatenate([outs[r][(case, mesh)][i], outs[r + 2][(case, mesh)][i]])
             for i in range(3)] for r in range(2)]


def _jax_grads(c, devices, mesh_name):
    if mesh_name == "sp2-data":
        mesh = Mesh(np.asarray(devices[:4]).reshape(2, 2), axis_names=("data", "sp"))
        batch_axis = "data"
    else:
        mesh = Mesh(np.asarray(devices[:4 if mesh_name == "sp4" else 2]), axis_names=("sp",))
        batch_axis = None

    @jax.jit
    def grads(q, k, v, km, cot):
        fn = lambda q, k, v: jax_ring(mesh, q, k, v, km, causal=c["causal"],  # noqa: E731
                                      need_unmasked=c["need_unmasked"], batch_axis=batch_axis)
        return jax.vjp(fn, q, k, v)[1](cot)

    args = [jnp.asarray(c[x]) for x in ("q", "k", "v", "km")]
    return [np.asarray(g) for g in grads(*args, tuple(jnp.asarray(c[x]) for x in COTANGENTS))]


@pytest.mark.parametrize("case,mesh", [(case, mesh) for case, (_, _, meshes) in JAX_CASES.items()
                                       for mesh in meshes])
def test_ring_gradients_match_jax_ring(world, eight_devices, case, mesh):
    cases, outs = world
    want = _jax_grads(cases[case], eight_devices, mesh)
    got = _rank_grads(outs, case, mesh)
    for g in got:
        for name, a, w in zip(("dq", "dk", "dv"), g, want):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=TOL, err_msg=name)
    # every rank of a ring ends with the same full gradients
    for g in got[1:]:
        for a, b in zip(g, got[0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", KEYLESS_MESHES)
def test_rows_without_a_key_follow_the_kernels(world, eight_devices, mesh):
    cases, outs = world
    c = cases["keyless"]
    q, k, v, km, g_out, g_lse, g_lse_u = _t(c, "q", "k", "v", "km", *COTANGENTS)
    want = flash_attention_backward_plain(q, k, v, km, *attention_plain(q, k, v, km), g_out,
                                          g_lse, g_lse_u)
    for g in _rank_grads(outs, "keyless", mesh):
        for name, a, w in zip(("dq", "dk", "dv"), g, want):
            np.testing.assert_allclose(a, w.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    # JAX's ring differentiated by autodiff sends v the keyless rows' g_out / T
    # (batch row 2 has no attendable key at all): there the conventions differ
    jax_dv = _jax_grads(c, eight_devices, mesh)[2]
    got_dv = _rank_grads(outs, "keyless", mesh)[0][2]
    np.testing.assert_allclose(got_dv[2], 0.0, atol=TOL)
    g_mean = c["g_out"][2].reshape(T, HKV, H // HKV, D).sum((0, 2)) / T
    np.testing.assert_allclose(jax_dv[2], np.broadcast_to(g_mean, (T, HKV, D)), rtol=1e-4,
                               atol=TOL)
