"""mimic_tpu_torch.models.moe without JAX: the router's noaux_tc choice and
weights, every (row, expert) assignment computed (no capacity, no row
dropped), the shared experts, the grouped product's plain loop, the spans
and counters; on a card, the block through ``torch._grouped_mm`` against
the CPU's, forward and backward, with no host sync.

    python -m pytest --noconftest tests/test_torch_moe.py -q
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mimic_tpu_torch.models import moe
from mimic_tpu_torch.models.config import tiny_text
from mimic_tpu_torch.utils import tracing

CFG = tiny_text("kimi-vl").text


def params(seed=0, E=8, D=64, Fe=32, Fs=32, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=0.1):
        return (torch.randn(shape, generator=g) * std).to(dtype)

    return {"router": r(D, E), "router_bias": r(E), "gate": r(E, D, Fe), "up": r(E, D, Fe),
            "down": r(E, Fe, D), "shared_gate": r(D, Fs), "shared_up": r(D, Fs),
            "shared_down": r(Fs, D)}


def by_row(x, mp, cfg):
    """The block row by row: each row's top-k experts by score + bias, their
    scores (no bias) normalised and scaled, plus the shared SwiGLU."""
    def swiglu(h, g, u, d):
        return (F.silu(h @ g) * (h @ u)) @ d

    out = []
    for h in x.reshape(-1, x.shape[-1]).float():
        s = torch.sigmoid(h @ mp["router"].float())
        b = (s + mp["router_bias"].float()).detach()
        chosen = sorted(range(len(s)), key=lambda e: -float(b[e]))
        chosen = chosen[: cfg.num_experts_per_tok]
        w = s[chosen] / (s[chosen].sum() + 1e-20) * cfg.routed_scaling_factor
        y = swiglu(h, *(mp[f"shared_{n}"].float() for n in ("gate", "up", "down")))
        for e, we in zip(chosen, w):
            y = y + we * swiglu(h, mp["gate"][e].float(), mp["up"][e].float(), mp["down"][e].float())
        out.append(y)
    return torch.stack(out).reshape(x.shape)


def test_route_picks_by_biased_score_and_weights_by_the_score():
    mp = params(1)
    # a bias that overturns the plain score order for some rows
    mp["router_bias"] = torch.linspace(-0.3, 0.3, 8)
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(2))
    idx, w = moe.route(x, mp, CFG)
    s = torch.sigmoid(x @ mp["router"])
    want = torch.topk(s + mp["router_bias"], CFG.num_experts_per_tok).indices
    assert torch.equal(idx, want)
    assert not torch.equal(torch.topk(s, CFG.num_experts_per_tok).indices, want)
    ws = s.gather(1, want)
    torch.testing.assert_close(w, ws / ws.sum(-1, keepdim=True) * 2.446)


def test_block_computes_every_assignment_with_the_shared_experts():
    mp = params(3)
    x = torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(4))
    got = moe.moe_block(x, mp, CFG)
    torch.testing.assert_close(got, by_row(x, mp, CFG), rtol=1e-5, atol=1e-5)


def test_block_with_one_expert_taking_every_row():
    """No capacity limit: a bias that sends every row to expert 0 drops none."""
    mp = params(5)
    mp["router_bias"] = torch.tensor([10.0] + [0.0] * 7)
    x = torch.randn(1, 50, 64, generator=torch.Generator().manual_seed(6))
    idx, _ = moe.route(x.reshape(50, 64), mp, CFG)
    assert (idx == 0).any(-1).all()
    torch.testing.assert_close(moe.moe_block(x, mp, CFG), by_row(x, mp, CFG),
                               rtol=1e-5, atol=1e-5)


def test_block_gradient_reaches_the_input_through_experts_and_router():
    mp = params(7)
    x0 = torch.randn(1, 12, 64, generator=torch.Generator().manual_seed(8))
    gy = torch.randn(1, 12, 64, generator=torch.Generator().manual_seed(9))
    grads = []
    for fn in (lambda x: moe.moe_block(x, mp, CFG), lambda x: by_row(x, mp, CFG)):
        x = x0.clone().requires_grad_(True)
        (fn(x) * gy).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-6)


def test_grouped_product_plain_loop():
    g = torch.Generator().manual_seed(10)
    x, w = torch.randn(20, 8, generator=g), torch.randn(4, 8, 6, generator=g)
    offs = torch.tensor([3, 3, 11, 20], dtype=torch.int32)
    want = torch.cat([x[:3] @ w[0], x[3:11] @ w[2], x[11:] @ w[3]])
    torch.testing.assert_close(moe.grouped_mm(x, w, offs), want)
    with pytest.raises(ValueError, match="frozen"):
        moe.grouped_mm(x, w.requires_grad_(True), offs)


def test_spans_and_counters():
    mp = params(11)
    x = torch.randn(2, 9, 64)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        moe.moe_block(x, mp, CFG)
    rec = tracing.recorded()
    assert rec["counts"] == {"moe_assignments": 18 * CFG.num_experts_per_tok,
                             "moe_grouped_launches": 3}
    spans = {s["name"]: s for s in rec["spans"]}
    assert set(spans) == {"moe.block", "moe.route", "moe.experts"}
    assert spans["moe.route"]["parent"] == spans["moe.block"]["id"]
    assert spans["moe.experts"]["parent"] == spans["moe.block"]["id"]
    tracing.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._grouped_mm has no CPU mode here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,E,D,Fe", [(300, 8, 128, 64), (1536, 64, 2048, 1408)])
def test_block_on_card_matches_the_cpu_without_a_host_sync(cuda_device, rows, E, D, Fe):
    """bf16 on the card (grouped products) against fp32 on the CPU (the plain
    loop) on the same rounded weights, forward and the input's gradient; the
    card's block never waits for the host (``set_sync_debug_mode("error")``)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, n_routed_experts=E, num_experts_per_tok=6 if E > 8 else 3,
                              moe_intermediate_size=Fe)
    mp = params(12, E=E, D=D, Fe=Fe, Fs=2 * Fe, dtype=torch.bfloat16)
    scale = D ** -0.5 / 0.1
    mp = {k: (v.float() * (1.0 if k.startswith("router") else scale)).to(torch.bfloat16)
          for k, v in mp.items()}
    x = torch.randn(1, rows, D, generator=torch.Generator().manual_seed(13)).to(torch.bfloat16)
    gy = torch.randn(1, rows, D, generator=torch.Generator().manual_seed(14)).to(torch.bfloat16)
    dev = {k: v.to(cuda_device) for k, v in mp.items()}
    xd = x.to(cuda_device).requires_grad_(True)
    gyd = gy.to(cuda_device).float()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.moe_block(xd, dev, cfg)
        (y.float() * gyd).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    xc = x.float().requires_grad_(True)
    yc = moe.moe_block(xc, {k: v.float() for k, v in mp.items()}, cfg)
    (yc * gy.float()).sum().backward()
    # rows whose k-th and (k+1)-th biased scores lie within bf16's rounding may
    # pick another expert: hold the rows that route alike
    idx_d, _ = moe.route(x.to(cuda_device).reshape(rows, D), dev, cfg)
    idx_c, _ = moe.route(x.float().reshape(rows, D), {k: v.float() for k, v in mp.items()}, cfg)
    same = (idx_d.cpu().sort(-1).values == idx_c.sort(-1).values).all(-1)
    assert same.float().mean() > 0.9
    for a, b in ((y.detach(), yc.detach()), (xd.grad, xc.grad)):
        a, b = a.float().cpu()[0][same], b[0][same]
        assert (a - b).abs().max().item() <= 0.05 * b.abs().max().item()
        assert ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item() <= 0.02
