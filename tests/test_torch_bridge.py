"""mimic_tpu_torch.bridge: JAX param pytree ↔ torch tree, bit-exact; device rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import ParamModule, to_numpy, to_torch, tree_leaves
from mimic_tpu_torch.device import resolve_device


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_bit_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lvlm_params_round_trip_bit_exact(dtype):
    cfg = get_model_config("tiny-idefics2")
    params = _np_tree(init_lvlm_params(cfg, jax.random.PRNGKey(0), dtype=dtype))
    tree_t = to_torch(params, device="cpu")
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert all(t.dtype == want for t in tree_leaves(tree_t))
    # the stacked [L, ...] layout survives as it is
    assert tree_t["lm"]["decoder"]["layers"]["q_proj"].shape == params["lm"]["decoder"]["layers"]["q_proj"].shape
    _assert_bit_equal(to_numpy(tree_t, bfloat16=jnp.bfloat16), params)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_idefics1_params_round_trip_bit_exact(dtype):
    """The idefics1 tree (cross layers with scalar gates, the resampler, the
    CLIP tower's class token and pre-layernorm) crosses both ways, and the
    port's own initialiser gives the same keys and shapes."""
    from mimic_tpu_torch.models.lvlm import init_lvlm_params as torch_init

    cfg = get_model_config("tiny-idefics1")
    params = _np_tree(init_lvlm_params(cfg, jax.random.PRNGKey(0), dtype=dtype))
    assert {"cross", "layers"} <= set(params["lm"]["decoder"])
    assert {"class_embed", "pre_ln_w", "pre_ln_b"} <= set(params["vision"])
    assert "perceiver" in params and "connector" not in params
    tree_t = to_torch(params, device="cpu")
    assert tree_t["lm"]["decoder"]["cross"]["alpha_attn"].shape == (cfg.text.num_cross_layers,)
    _assert_bit_equal(to_numpy(tree_t, bfloat16=jnp.bfloat16), params)
    mine = torch_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == jax.tree.map(np.shape, params)


def test_bf16_values_cross_unchanged():
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16))
    t = to_torch({"x": x}, device="cpu")["x"]
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    # without a bfloat16 numpy dtype, bf16 leaves come back as uint16 bit patterns
    bits = to_numpy({"x": t})["x"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, x.view(np.uint16))


@pytest.mark.parametrize("preset", ["mimic", "licv", "attn_shift_ffn_mse"])
def test_shift_params_round_trip_bit_exact(preset):
    enc_cfg, _ = get_preset(preset)
    cfg = get_model_config("tiny-idefics2")
    shift = _np_tree(init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(3)))
    assert shift
    _assert_bit_equal(to_numpy(to_torch(shift, device="cpu")), shift)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_zero_dim_leaves_keep_their_shape(dtype):
    tree = {"s": np.asarray(jnp.asarray(1.5, dtype)), "v": np.asarray(jnp.ones((2,), dtype))}
    t = to_torch(tree, "cpu")
    assert t["s"].shape == () and t["v"].shape == (2,)
    back = to_numpy(t, bfloat16=jnp.bfloat16)
    for k, x in tree.items():
        assert back[k].dtype == x.dtype and back[k].shape == x.shape
        assert back[k].tobytes() == x.tobytes()


def test_param_module_rebuilds_tree_and_moves_dtype():
    cfg = get_model_config("tiny-idefics2")
    tree_t = to_torch(_np_tree(init_lvlm_params(cfg, jax.random.PRNGKey(0))), device="cpu")
    mod = ParamModule(tree_t)
    back = mod.tree()
    flat_a, flat_b = tree_leaves(tree_t), tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    assert all(a is b for a, b in zip(flat_a, flat_b))
    assert back.keys() == tree_t.keys()
    moved = mod.to(torch.float64).tree()
    assert all(t.dtype == torch.float64 for t in tree_leaves(moved))


def test_resolve_device_raises_instead_of_falling_back():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # None is the card: the default never moves to the CPU
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda" and resolve_device(None).type == "cuda"
        assert resolve_device().type == "cuda"
        with pytest.raises(RuntimeError):
            resolve_device(f"cuda:{torch.cuda.device_count()}")
    else:
        for device in ("cuda", None):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(device)
