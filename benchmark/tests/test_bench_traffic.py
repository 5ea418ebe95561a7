"""Each traffic generator is a function of its seed: the same seed gives the
same inputs, another seed other contents of the same sizes."""

import numpy as np
import pytest

from benchmark.tests import tiny
from benchmark.lib import registry


def train_inputs(seed, family="idefics2"):
    wl, cfg = tiny.train_cell(family)
    return registry.traffic("mimic_train").raw_batches(cfg, wl["params"], seed)


def eval_inputs(seed):
    wl, cfg = tiny.eval_cell()
    return registry.traffic("vqa_eval").raw_calls(cfg, wl["params"], seed)


def flat(batches):
    texts, images = [], []
    for rows in batches:
        for r in rows:
            texts += [r["prefix"], r["query"], r["answer"]]
            images += r["images"]
    return texts, images


def flat_eval(calls):
    return ([t for c in calls for t in c["texts"]],
            [im for c in calls for row in c["images"] for im in row])


@pytest.mark.parametrize("make,unpack", [(train_inputs, flat), (eval_inputs, flat_eval)])
def test_bench_generator_is_seeded(make, unpack):
    big = 2**31 + 12345
    t1, i1 = unpack(make(big))
    t2, i2 = unpack(make(big))
    t3, i3 = unpack(make(big + 1))
    assert t1 == t2 and all(np.array_equal(a, b) for a, b in zip(i1, i2))
    assert t1 != t3 and not all(np.array_equal(a, b) for a, b in zip(i1, i3))
    # the same sizes in another order
    assert sorted(map(len, t1)) == sorted(map(len, t3))
    assert sorted(a.shape for a in i1) == sorted(a.shape for a in i3)


def test_bench_questions_have_their_lengths():
    from benchmark.lib import gen
    rng = gen.rng_for(3)
    for n in range(14, 120):
        q = gen.question(rng, n)
        assert len(q) == n and q.endswith("?")
