"""``benchmark/flops/`` against a count by enumeration at tiny configurations
of both families: every weight's multiply-adds row by row, every attended
(row, key) pair one by one."""

import numpy as np
import pytest

from benchmark.tests import tiny
from benchmark.lib import registry
from benchmark.lib.weights import sizes, specs


def leaf_ops(cfg, prefix, name):
    """2 x in x out of one layer's weight ``prefix/name``."""
    for path, shape, _ in specs(cfg):
        if path[:len(prefix)] == prefix and path[-1] == name:
            return 2 * shape[-2] * shape[-1]
    raise KeyError(name)


def attn_pairs(ok, shift):
    """(masked pairs, pairs QKᵀ needs, dead rows) by enumeration, every row."""
    masked = qk = dead = 0
    B, T = ok.shape
    for b in range(B):
        for t in range(T):
            n = sum(ok[b, s] for s in range(t + 1))
            masked += n
            dead += n == 0
            qk += T if shift else n
    return masked, qk, dead


@pytest.mark.parametrize("family", ["idefics2", "llava_interleave"])
def test_bench_eval_call_by_enumeration(family):
    cfg = tiny.config(family)
    s = sizes(cfg)
    ok = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], bool)
    valid = [4, 3] if family == "idefics2" else [4, 4]
    geo = dict(prompt_key_ok=ok, valid=valid, beams=2, new_tokens=3)
    got = registry.flops(family).eval_call(s, geo)["model_flops"]

    dec = ("lm", "decoder", "layers")
    per_row = sum(leaf_ops(cfg, dec, n) for n in
                  ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"))
    head = leaf_ops(cfg, ("lm",), "lm_head")
    H, Dh, L = s["H"], s["Dh"], s["L"]
    masked, qk, dead = attn_pairs(ok, shift=True)
    prefill = L * (ok.size * per_row + 2 * Dh * H * (qk + masked + dead * ok.shape[1]))
    prefill += 2 * head                                         # last row of each prompt
    decode = 0
    for i in (1, 2):                                            # new_tokens - 1 steps
        for b in range(2):
            for _ in range(2):                                  # beams
                keys_all = ok.shape[1] + i
                keys_ok = ok[b].sum() + i
                decode += L * (per_row + 2 * Dh * H * (keys_all + keys_ok)) + head
    decode_avg = decode                                         # (the count averages rows)
    vis = ("vision", "layers")
    vit = 0
    for n in valid:
        vit += 2 * n * s["patch"] ** 2 * 3 * s["Dv"]
        vit += s["Lv"] * (n * sum(leaf_ops(cfg, vis, x) for x in
                                  ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2"))
                          + 4 * s["Dv"] * n * n)
    if family == "idefics2":
        conn = 0
        con = ("connector", "layers")
        lat = s["latents"]
        mp = ("connector", "modality_proj")
        for n in valid:
            conn += n * (leaf_ops(cfg, mp, "gate") + leaf_ops(cfg, mp, "up")
                         + leaf_ops(cfg, mp, "down"))
            conn += s["Lp"] * (lat * leaf_ops(cfg, con, "q_proj")
                               + (n + lat) * (leaf_ops(cfg, con, "k_proj")
                                              + leaf_ops(cfg, con, "v_proj"))
                               + 4 * s["Hp"] * s["Dhp"] * lat * (n + lat)
                               + lat * (leaf_ops(cfg, con, "o_proj") + leaf_ops(cfg, con, "gate_proj")
                                        + leaf_ops(cfg, con, "up_proj")
                                        + leaf_ops(cfg, con, "down_proj")))
    else:
        pr = ("projector",)
        conn = sum(n * (leaf_ops(cfg, pr, "fc1") + leaf_ops(cfg, pr, "fc2")) for n in valid)
    want = vit + conn + prefill + decode_avg
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("family", ["idefics2", "llava_interleave"])
def test_bench_train_step_by_enumeration(family):
    cfg = tiny.config(family)
    s = sizes(cfg)
    rec = np.array([[1, 1, 0, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    sh = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    geo = dict(rec_key_ok=rec, shift_key_ok=sh, rec_valid=np.array([4, 2, 4, 4]),
               shift_valid=np.array([2, 4]), ce_rows=float(sh[:, 1:].sum()))
    fl = registry.flops(family)
    got = fl.train_step(s, geo)["model_flops"]
    dec = ("lm", "decoder", "layers")
    ops = {n: leaf_ops(cfg, dec, n) for n in
           ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")}
    per_row = sum(ops.values())
    head = leaf_ops(cfg, ("lm",), "lm_head")
    H, Dh, L = s["H"], s["Dh"], s["L"]
    # record pass: real rows only, no shift, last row's logits
    m_rec = sum(sum(rec[b, :t + 1]) for b in range(2) for t in range(6) if rec[b, t])
    want = L * (rec.sum() * per_row + 4 * Dh * H * m_rec) + 2 * head
    # shift pass: every row, log Z2 over every key, logits where a next token counts
    masked, qk, dead = attn_pairs(sh, shift=True)
    want += L * (sh.size * per_row + 2 * Dh * H * (qk + masked + dead * sh.shape[1]))
    want += head * geo["ce_rows"]
    # backward: layers 1..L-1 whole (qkv, o, MLP, attention), layer 0 o and MLP only
    o_mlp = ops["o_proj"] + ops["gate_proj"] + ops["up_proj"] + ops["down_proj"]
    want += (L - 1) * (sh.size * per_row + 4 * Dh * H * (masked + qk)) + sh.size * o_mlp
    want += head * geo["ce_rows"]
    images = np.concatenate([geo["rec_valid"], geo["shift_valid"]])
    want += fl.connector(s, images)
    vis = ("vision", "layers")
    for n in images:
        want += 2 * n * s["patch"] ** 2 * 3 * s["Dv"]
        want += s["Lv"] * (n * sum(leaf_ops(cfg, vis, x) for x in
                                   ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2"))
                           + 4 * s["Dv"] * n * n)
    assert got == pytest.approx(want, rel=1e-12)
