"""A new family joins the benchmark by its own files alone.

The probe family (``probe/``: ``configs/tiny-probe.json``,
``reference/probe.py``, ``flops/probe.py``) has what the next families need
and the present two lack: a shift whose log Z1 weight is wider than its v
(query heads wider than value heads, as in latent attention), a leaf group
of its own (stacked experts), image tokens that depend on the image's size,
and its own reference decoder.  Its files go into a copy of ``benchmark/``
beside the shared code, unchanged, and the shared code routes through them.
The port cannot run the probe, so no ``Traffic.setup`` runs here."""

import copy
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import program, registry
from benchmark.lib.family import Defaulted
from benchmark.lib.trace import Spans
from benchmark.lib.weights import make_shift, make_weights, sizes, specs
from benchmark.reference import mimic, plain

PROBE = Path(__file__).resolve().parent / "probe"
CPU = torch.device("cpu")
SEED = 2**31 + 11
SHIFT_INIT = {"attn_v_std": 0.01, "logz1_w_std": 0.02, "logz1_b": 0.0}
# 2, 2 and 4 patches carry pixels: 2, 2 and 4 tokens
IMAGE_SIZES = [[14, 28], [28, 14], [28, 28]]


@pytest.fixture
def probe(tmp_path, monkeypatch):
    """The probe's configuration and family module, found by name in a copy
    of ``benchmark/`` that holds its three files besides."""
    bench = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    added = []
    for src in sorted(p for p in PROBE.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        dst = bench / src.relative_to(PROBE)
        assert not dst.exists()
        shutil.copy(src, dst)
        added.append(str(src.relative_to(PROBE)))
    assert added == ["configs/tiny-probe.json", "flops/probe.py", "reference/probe.py"]
    monkeypatch.setattr(registry, "BENCH_DIR", bench)
    cfg = registry.config("tiny-probe")
    return cfg, registry.reference(cfg["family"])


def test_bench_probe_supplies_the_contract(probe):
    from benchmark.tests.test_bench_family_seam import CONTRACT

    _, fam = probe
    assert not [f for f in CONTRACT if not callable(getattr(fam, f, None))]


def train_params():
    p = copy.deepcopy(registry.workload("llava-interleave-7b.mimic-train-4shot")["params"])
    p.update(demos=2, demo_question_chars=[14, 18], demo_answer_chars=[1, 3],
             query_question_chars=[15, 16], answer_chars=[3, 2], pad_multiple=16,
             image_sizes=IMAGE_SIZES, distinct_batches=3, shift_init=SHIFT_INIT)
    return {"params": p}


def test_bench_probe_tree_and_shift(probe):
    cfg, fam = probe
    s = sizes(cfg)
    assert s == fam.sizes(cfg) and s["Dq"] > s["Dh"]
    leaves = {path: shape for path, shape, _ in specs(cfg)}
    L, E, D, Fe = s["L"], s["E"], s["D"], s["Fe"]
    assert leaves[("lm", "decoder", "experts", "gate")] == (L, E, D, Fe)
    tree = make_weights(cfg, SEED, CPU, torch.float32)
    assert tuple(tree["lm"]["decoder"]["experts"]["down"].shape) == (L, E, Fe, D)
    assert tuple(tree["projector"]["fc"].shape) == (s["Dv"], D)
    shift = make_shift(cfg, SHIFT_INIT, SEED, CPU)
    assert {k: tuple(v.shape) for k, v in shift.items()} == fam.shift_shapes(s)
    assert shift["attn_logz1_w"].shape[-1] == s["Dq"] > shift["attn_v"].shape[-1] == s["Dh"]


def stub_config(want):
    """A port configuration that holds ``want`` (a Defaulted key left unset)."""
    root = SimpleNamespace()
    for key, value in want.items():
        node = root
        *parts, last = key.split(".")
        for part in parts:
            if not hasattr(node, part):
                setattr(node, part, SimpleNamespace())
            node = getattr(node, part)
        setattr(node, last, None if isinstance(value, Defaulted) else value)
    return root


def test_bench_probe_architecture_check(probe):
    cfg, fam = probe
    pcfg = stub_config(fam.expect(cfg, fam.sizes(cfg)))
    program.check_architecture(pcfg, cfg)
    pcfg.text.expert_size = 99
    with pytest.raises(ValueError, match="text.expert_size: program 99"):
        program.check_architecture(pcfg, cfg)
    pcfg.text.expert_size = None
    pcfg.text.qk_head_dim -= 1
    with pytest.raises(ValueError, match="text.qk_head_dim"):
        program.check_architecture(pcfg, cfg)


def test_bench_probe_expands_each_image_to_its_own_tokens(probe):
    cfg, fam = probe
    s = fam.sizes(cfg)
    wl = train_params()
    tokens = {tuple(hw): fam.image_tokens(hw, cfg, s) for hw in IMAGE_SIZES}
    assert len(set(tokens.values())) > 1
    rows = registry.traffic("mimic_train").raw_batches(cfg, wl["params"], SEED)[0]
    c = mimic.collate(fam, cfg, s, rows, wl["params"]["pad_multiple"])
    for b, r in enumerate(rows):
        hw = [tuple(im.shape[:2]) for im in r["images"]]
        assert (c["f_ids"][b] == plain.IMAGE).sum() == sum(tokens[x] for x in hw)
        assert (c["q_ids"][b] == plain.IMAGE).sum() == tokens[hw[-1]]
    # the eval's prompt widths too: one question an image
    ev = copy.deepcopy(registry.workload("idefics2-8b.vqa-eval-b32"))
    ev["params"].update(questions_per_call=3, pool_calls=2, question_chars=[20] * 3,
                        pad_multiple=1, image_sizes=IMAGE_SIZES)
    tr = registry.traffic("vqa_eval").Traffic(cfg, ev, SEED, CPU, torch.float32, Spans(False))
    for call in tr.calls:
        lens = tr.prompt_lengths(call)
        assert [n - lens[0] for n in lens] == [
            tokens[im[0].shape[:2]] - tokens[call["images"][0][0].shape[:2]]
            for im in call["images"]]


def test_bench_probe_train_runs_through_its_decoder(probe, monkeypatch):
    cfg, fam = probe
    wl = train_params()
    p = wl["params"]
    calls = []
    own = fam.decoder

    def counted(*args, **kwargs):
        calls.append(kwargs.get("remat", False))
        return own(*args, **kwargs)

    monkeypatch.setattr(fam, "decoder", counted)
    tr = registry.traffic("mimic_train").Traffic(cfg, wl, SEED, CPU, torch.float32, Spans(False))
    rows = tr.raw[0]
    c = mimic.collate(fam, cfg, fam.sizes(cfg), rows, p["pad_multiple"])
    work = tr.count(rows, c["f_ids"] != plain.PAD, c["q_ids"] != plain.PAD)
    assert work["model_flops"] > 0
    shift0 = make_shift(cfg, SHIFT_INIT, SEED, CPU)
    with plain.no_tf32():
        out = mimic.train(fam, cfg, make_weights(cfg, SEED, CPU, torch.float32), tr.raw[:3],
                          shift0, p["optimizer"], {"ce": 1.0, "align": 1.0}, p["pad_multiple"],
                          plain.Precision("fp32"), CPU)
    assert calls == [False, True] * 3          # record pass, shift pass, each step
    assert len(out["losses"]) == 3 and all(math.isfinite(x) for x in out["losses"])
    for k, v in shift0.items():
        for part in ("grad", "delta"):
            assert out[part][k].shape == v.shape
            assert torch.isfinite(out[part][k]).all()
            assert float(out[part][k].norm()) > 0, (part, k)
