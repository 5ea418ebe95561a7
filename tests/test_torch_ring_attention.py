"""mimic_tpu_torch.ops.ring_attention against the JAX package's ring and the
plain attention on the gathered sequence, fp32.

``ring_attention_sharded`` on four ``gloo`` processes: the sequence over
``sp`` 4, over ``sp`` 2 with the batch whole on both rings, and over ``sp``
2 with the batch split over ``data`` (``batch_axis``), causal and not, with
GQA and a key mask holding left padding, interior pads and a row with no
attendable key at all.  ``(out, lse, lse_unmasked)`` agree within 1e-5 with
JAX's ``ring_attention_sharded`` on virtual devices and with one
``attention_plain`` call; the row without a key is the mean of v over all T
keys (finite, lse at NEG), as JAX's ring gives it.  With gradients recorded
the ring's q/k/v gradients on ``sp`` 4 agree within 1e-5 with autograd
through ``attention_plain`` on the whole sequence (the cotangents zero on
rows with no attendable key, where the two conventions differ; see
``tests/test_torch_ring_backward.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mimic_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from mimic_tpu_torch.ops.flash_attention import NEG, attention_plain
from mimic_tpu_torch.ops.ring_attention import RingMerge, ring_block
from torch_dist import run_world

TOL = 1e-5
B, T, H, HKV, D = 4, 64, 4, 2, 16
MESHES = ["sp4", "sp2", "sp2-data"]


def _inputs(causal, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    km = np.ones((B, T), np.int32)
    km[0, :21] = 0      # left padding across the first ring chunk
    km[1, 20:23] = 0    # interior pads
    km[2, :] = 0        # a row with no attendable key
    km[3, 50:] = 0      # suffix padding
    return {"q": q, "k": k, "v": v, "km": km, "causal": causal}


def _grad_cotangents(c, seed):
    """Random cotangents of (out, lse, lse_u), zero on out and lse at rows
    with no attendable key."""
    rng = np.random.default_rng(seed)
    allowed = (c["km"] != 0)[:, None, :] & np.tril(np.ones((T, T), bool))[None]
    has_key = allowed.any(-1)[..., None]  # [B, T, 1]
    g_out = rng.normal(size=(B, T, H, D)).astype(np.float32) * has_key[..., None]
    g_lse = rng.normal(size=(B, T, H)).astype(np.float32) * has_key
    return [g_out, g_lse, rng.normal(size=(B, T, H)).astype(np.float32)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {"causal": _inputs(True, 0), "noncausal": _inputs(False, 1)}
    cot = _grad_cotangents(cases["causal"], 3)
    outs = run_world("torch_workers:ring_world", 4, tmp_path_factory.mktemp("ring"),
                     {"cases": cases, "grad_cotangents": cot})
    return cases, outs, cot


def _gathered(outs, case, mesh):
    """Each rank's full-length result (the data mesh: its two rows)."""
    if mesh != "sp2-data":
        return [o[(case, mesh)] for o in outs]
    return [[np.concatenate([outs[r][(case, mesh)][i], outs[r + 2][(case, mesh)][i]])
             for i in range(3)] for r in range(2)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["causal", "noncausal"])
def test_ring_matches_plain_on_the_gathered_sequence(world, case, mesh):
    cases, outs, _ = world
    c = cases[case]
    want = attention_plain(*(torch.from_numpy(c[x]) for x in ("q", "k", "v", "km")),
                           causal=c["causal"])
    for got in _gathered(outs, case, mesh):
        for g, w in zip(got, want):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w.numpy(), rtol=TOL, atol=TOL)
    # the row with no attendable key: the mean of v over all T keys
    v_mean = np.repeat(c["v"][2].mean(0), H // HKV, axis=0)
    np.testing.assert_allclose(got[0][2], np.broadcast_to(v_mean, (T, H, D)), atol=TOL)
    assert (got[1][2] <= NEG / 2).all()


@pytest.mark.parametrize("n_sp", [2, 4])
@pytest.mark.parametrize("case", ["causal", "noncausal"])
def test_ring_matches_jax_ring(world, eight_devices, case, n_sp):
    cases, outs, _ = world
    c = cases[case]
    mesh = Mesh(np.asarray(eight_devices[:n_sp]), axis_names=("sp",))
    want = jax_ring(mesh, *(jnp.asarray(c[x]) for x in ("q", "k", "v", "km")), causal=c["causal"])
    for got in _gathered(outs, case, "sp4" if n_sp == 4 else "sp2"):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_ring_with_gradients_raises(world):
    """(The name is kept from when the ring had no backward.)  The ring
    records gradients: every rank's q/k/v gradients on sp 4 against autograd
    through one attention_plain call."""
    cases, outs, cot = world
    c = cases["causal"]
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in ("q", "k", "v"))
    want = torch.autograd.grad(attention_plain(q, k, v, torch.from_numpy(c["km"])), (q, k, v),
                               [torch.from_numpy(g) for g in cot])
    for out in outs:
        for g, w in zip(out["grads"], want):
            np.testing.assert_allclose(g, w.numpy(), rtol=TOL, atol=TOL)


def test_blocks_and_merge_in_one_process():
    """The ring's blocks and merge without the exchange: rank r's chunk over
    every rank's block, merged, equals rank r's rows of the whole attention;
    a future block carries lse_u only."""
    c = _inputs(True, 2)
    q, k, v, km = (torch.from_numpy(c[x]) for x in ("q", "k", "v", "km"))
    n, C = 4, T // 4
    want = attention_plain(q, k, v, km, causal=True)
    for r in range(n):
        merge = RingMerge()
        rows = slice(r * C, (r + 1) * C)
        for j in range(n):
            cols = slice(j * C, (j + 1) * C)
            out, lse, lse_u = ring_block(q[:, rows], k[:, cols], v[:, cols], km[:, cols], r, j,
                                         True, None, True)
            if j > r:
                assert (lse <= NEG / 2).all() and (lse_u > NEG / 2).all()
            merge.add(out, lse, lse_u)
        for g, w in zip(merge.result(q.dtype), want):
            torch.testing.assert_close(g, w[:, rows], rtol=TOL, atol=TOL)
