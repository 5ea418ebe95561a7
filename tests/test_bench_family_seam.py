"""The benchmark's family seam, held in the tier-1 run: each family
(``benchmark/reference/<family>.py``: idefics2, llava_interleave and
kimi_vl) supplies the contract, the two configurations that were there
before the seam keep their leaves, sizes, shift shapes, port keys and work
counts (``benchmark/tests/data/frozen-719c696.json``), and no shared module
of the benchmark names a family.  No weights are made and no JAX is imported.

The same checks, with the tiny-size bit-for-bit ones, are in
``benchmark/tests/test_bench_family_seam.py`` (``python -m pytest benchmark/tests``).
"""

import ast

import pytest
import torch

from benchmark.lib import registry
from benchmark.lib.family import Defaulted
from benchmark.lib.trace import Spans
from benchmark.lib.weights import sizes, specs
from benchmark.reference import mimic, plain
from benchmark.tests import test_bench_family_seam as seam

FAMILIES = ["idefics2", "kimi_vl", "llava_interleave"]


def test_every_family_is_found():
    assert seam.FAMILIES == FAMILIES
    assert {"idefics2", "llava", "kimi", "kimi_vl", "kimi-vl-a3b-instruct"} <= seam.family_words()


@pytest.mark.parametrize("name", FAMILIES)
def test_family_supplies_the_contract(name):
    fam = registry.reference(name)
    assert not [f for f in seam.CONTRACT if not callable(getattr(fam, f, None))]
    flops = registry.flops(name)
    assert callable(flops.train_step) and callable(flops.eval_call)


@pytest.mark.parametrize("name", seam.CONFIGS)
def test_present_configurations_keep_their_leaves_and_keys(name):
    cfg = registry.config(name)
    fam = registry.reference(cfg["family"])
    s = fam.sizes(cfg)
    want = seam.FROZEN["configs"][name]
    assert seam.jsonable(s) == want["sizes"] == seam.jsonable(sizes(cfg))
    assert seam.jsonable(fam.specs(cfg, s)) == want["specs"] == seam.jsonable(specs(cfg))
    assert seam.jsonable(fam.shift_shapes(s)) == want["shift_shapes"]
    expect = {k: v.value if isinstance(v, Defaulted) else v for k, v in fam.expect(cfg, s).items()}
    assert seam.jsonable(expect) == want["expect"]


@pytest.mark.parametrize("cell", seam.CELLS)
def test_present_cells_keep_their_work_counts(cell):
    seed = 1
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    tr = registry.traffic(wl["traffic"]).Traffic(cfg, wl, seed, torch.device("cpu"),
                                                torch.bfloat16, Spans(False))
    frozen = seam.FROZEN["cells"][cell]
    if wl["traffic"] == "mimic_train":
        work = []
        for rows in tr.raw:
            c = mimic.collate(tr.fam, cfg, tr.fam.sizes(cfg), rows, wl["params"]["pad_multiple"])
            work.append(tr.count(rows, c["f_ids"] != plain.PAD, c["q_ids"] != plain.PAD))
    else:
        assert tr.widths == frozen["widths"][str(seed)]
        work = [tr.count(i) for i in range(len(tr.calls))]
    assert seam.jsonable(work) == frozen[str(seed)]


@pytest.mark.parametrize("path", seam.SHARED, ids=lambda p: str(p.relative_to(seam.BENCH)))
def test_shared_module_names_no_family(path):
    tree = ast.parse(path.read_text())
    words = seam.family_words()
    named = sorted({w for w in seam.code_words(tree) for f in words if f in w.lower()})
    assert not named, f"{path.name} names a family: {named}"
    branches = [line for line, loads in seam.family_reads(tree) if not loads]
    assert not branches, f"{path.name} reads cfg['family'] other than to load it: {branches}"
