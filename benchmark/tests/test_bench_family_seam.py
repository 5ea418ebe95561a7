"""The family seam changed nothing, and the shared code names no family.

Each family's architecture lives in ``reference/<family>.py`` alone.  The
values here were taken at commit 719c696, before it moved there
(``data/frozen-719c696.json``): the leaves of both real configurations
(path, shape, init and drawing order), their sizes, shift shapes and the
port's keys; the work counts of the three cells at their real geometries;
and, at tiny size on the CPU, the weights, the shift and the reference's
three steps bit for bit."""

import ast
import hashlib
import json
import re

import pytest
import torch

from benchmark.tests import tiny
from benchmark.lib import program, registry
from benchmark.lib.family import Defaulted
from benchmark.lib.trace import Spans
from benchmark.lib.weights import make_shift, make_weights, sizes, specs
from benchmark.reference import mimic, plain

FROZEN = json.loads((tiny.DATA / "frozen-719c696.json").read_text())
BENCH = registry.BENCH_DIR
CONFIGS = sorted(FROZEN["configs"])
SEED = 2**31 + 7


def jsonable(x):
    return json.loads(json.dumps(x))


def digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", CONFIGS)
def test_bench_leaves_sizes_and_keys_are_the_parents(name):
    cfg = registry.config(name)
    fam = registry.reference(cfg["family"])
    s = fam.sizes(cfg)
    want = FROZEN["configs"][name]
    assert jsonable(s) == want["sizes"] == jsonable(sizes(cfg))
    assert jsonable(fam.specs(cfg, s)) == want["specs"] == jsonable(specs(cfg))
    assert jsonable(fam.shift_shapes(s)) == want["shift_shapes"]
    expect = {k: v.value if isinstance(v, Defaulted) else v for k, v in fam.expect(cfg, s).items()}
    assert jsonable(expect) == want["expect"]
    shift = make_shift(cfg, {"attn_v_std": 1e-3, "logz1_w_std": 0.02, "logz1_b": 0.0}, 1,
                       tiny.CPU)
    assert {k: list(v.shape) for k, v in shift.items()} == want["shift_shapes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_bench_port_config_passes_the_architecture_check(name):
    from mimic_tpu_torch.models.config import get_model_config

    cfg = registry.config(name)
    pcfg = get_model_config(cfg["program_model"])
    program.check_architecture(pcfg, cfg)
    wrong = pcfg.replace(text=pcfg.text.__class__(**{**pcfg.text.__dict__, "num_layers": 3}))
    with pytest.raises(ValueError, match="text.num_layers"):
        program.check_architecture(wrong, cfg)


CELLS = sorted(FROZEN["cells"])


@pytest.mark.parametrize("seed", [1, 2**31 + 17])
@pytest.mark.parametrize("cell", CELLS)
def test_bench_work_at_the_real_geometry_is_the_parents(cell, seed):
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    tr = registry.traffic(wl["traffic"]).Traffic(cfg, wl, seed, tiny.CPU, torch.bfloat16,
                                                Spans(False))
    frozen = FROZEN["cells"][cell]
    if wl["traffic"] == "mimic_train":
        work = []
        for rows in tr.raw:
            c = mimic.collate(tr.fam, cfg, tr.fam.sizes(cfg), rows, wl["params"]["pad_multiple"])
            work.append(tr.count(rows, c["f_ids"] != plain.PAD, c["q_ids"] != plain.PAD))
    else:
        assert tr.widths == frozen["widths"][str(seed)]
        work = [tr.count(i) for i in range(len(tr.calls))]
    assert jsonable(work) == frozen[str(seed)]


def tree_digests(tree, path=()):
    if isinstance(tree, dict):
        return [d for k in tree for d in tree_digests(tree[k], path + (k,))]
    return [["/".join(path), digest(tree)]]


@pytest.mark.parametrize("family", ["idefics2", "llava_interleave"])
def test_bench_tiny_weights_shift_and_reference_are_the_parents_bit_for_bit(family):
    from mimic_tpu_torch.config import get_preset

    want = FROZEN["tiny"][family]
    wl, cfg = tiny.train_cell(family)
    p = wl["params"]
    for dt in ("float32", "bfloat16"):
        got = tree_digests(make_weights(cfg, SEED, tiny.CPU, getattr(torch, dt)))
        assert got == want["weights_" + dt]
    shift0 = make_shift(cfg, p["shift_init"], SEED, tiny.CPU)
    assert {k: digest(v) for k, v in shift0.items()} == want["shift"]
    _, peft = get_preset(p["preset"])
    loss_w = {"ce": peft.ce_loss_weight, "align": peft.align_loss_weight}
    batches = registry.traffic("mimic_train").raw_batches(cfg, p, SEED)[:3]
    weights = make_weights(cfg, SEED, tiny.CPU, torch.float32)
    with plain.no_tf32():
        r = mimic.train(registry.reference(family), cfg, weights, batches, shift0,
                        p["optimizer"], loss_w, p["pad_multiple"], plain.Precision("fp32"),
                        tiny.CPU)
    assert [float(x).hex() for x in r["losses"]] == want["losses"]
    assert {k: digest(v) for k, v in r["grad"].items()} == want["grad"]
    assert {k: digest(v) for k, v in r["delta"].items()} == want["delta"]


def test_bench_tiny_beam_logprobs_are_the_parents_bit_for_bit():
    wl, cfg = tiny.eval_cell()
    tr = registry.traffic("vqa_eval").Traffic(cfg, wl, SEED, tiny.CPU, torch.float32,
                                             Spans(False))
    want = FROZEN["tiny"]["beam_logprobs"]
    assert tr.widths == want["widths"]
    weights = make_weights(cfg, SEED, tiny.CPU, torch.float32)
    shift = make_shift(cfg, wl["params"]["shift_init"], SEED, tiny.CPU)
    with plain.no_tf32():
        lp = mimic.beam_logprobs(tr.fam, cfg, weights, shift, tr.calls[0]["texts"][1],
                                 tr.calls[0]["images"][1][0], tr.widths[0], [65, 66, 258],
                                 plain.Precision("fp32"), tiny.CPU)
    assert digest(lp) == want["digest"]


# ---------------------------------------------------------------------------
# the shared code names no family
# ---------------------------------------------------------------------------

FAMILY_FILES = {"plain", "mimic", "__init__"}
FAMILIES = sorted(p.stem for p in (BENCH / "reference").glob("*.py")
                  if p.stem not in FAMILY_FILES)
SHARED = sorted([*(BENCH / "lib").glob("*.py"), *(BENCH / "traffic").glob("*.py"),
                 *(BENCH / "metrics").glob("*.py"), BENCH / "reference" / "plain.py",
                 BENCH / "reference" / "mimic.py", BENCH / "run.py", BENCH / "calibrate.py"])


def family_words():
    words = set()
    for stem in FAMILIES:
        words |= {stem, re.split(r"[-_]", stem)[0]}
    for path in (BENCH / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        words |= {cfg["name"], cfg["program_model"], cfg["family"]}
    return {w.lower() for w in words}


def code_words(tree):
    """Identifiers and string constants, docstrings left out."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr
        elif isinstance(n, (ast.FunctionDef, ast.ClassDef, ast.arg)):
            yield n.name if not isinstance(n, ast.arg) else n.arg
        elif isinstance(n, ast.alias):
            yield n.name
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            yield n.value


def family_reads(tree):
    """Each read of a configuration's ``family`` key, and whether it is the
    argument that loads the family's module (``registry.reference`` or
    ``registry.flops``)."""
    loads = {id(n.args[0]) for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr in ("reference", "flops") and n.args}
    keys = {id(n.slice): n for n in ast.walk(tree) if isinstance(n, ast.Subscript)}
    for n in ast.walk(tree):
        if isinstance(n, ast.Constant) and n.value == "family":
            sub = keys.get(id(n))   # None: cfg.get("family") and the like
            yield n.lineno, sub is not None and id(sub) in loads


CONTRACT = ("sizes", "specs", "shift_shapes", "expect", "decoder", "process_image",
            "image_tokens", "vit_rows", "expand", "encode_image")


@pytest.mark.parametrize("name", FAMILIES)
def test_bench_family_module_supplies_the_contract(name):
    fam = registry.reference(name)
    assert not [f for f in CONTRACT if not callable(getattr(fam, f, None))]
    assert callable(registry.flops(name).train_step) and callable(registry.flops(name).eval_call)


def test_bench_the_family_words_are_found():
    assert {"idefics2", "llava", "llava_interleave"} <= family_words()


@pytest.mark.parametrize("path", SHARED, ids=lambda p: str(p.relative_to(BENCH)))
def test_bench_shared_module_names_no_family(path):
    tree = ast.parse(path.read_text())
    words = family_words()
    named = sorted({w for w in code_words(tree) for f in words if f in w.lower()})
    assert not named, f"{path.name} names a family: {named}"
    branches = [line for line, loads in family_reads(tree) if not loads]
    assert not branches, f"{path.name} reads cfg['family'] other than to load it: {branches}"


def test_bench_the_name_check_catches_a_branch():
    bad = ast.parse('if cfg["family"] == "idefics2":\n    x = registry.reference(cfg["family"])\n')
    assert [ok for _, ok in family_reads(bad)] == [False, True]
    assert "idefics2" in set(code_words(bad))
    doc = ast.parse('"""idefics2 in a docstring"""\nx = 1\n')
    assert not {w for w in code_words(doc) if "idefics" in w}
