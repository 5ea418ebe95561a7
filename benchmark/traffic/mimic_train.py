"""Traffic kind ``mimic_train``: MimIC's dual-pass train step, back to back.

Set-up makes the cell's raw batches from the seed (rows of instruction,
demonstrations with their images, a query image, its question and answer;
the lengths and image sizes of the workload file, in a seeded order), runs
them through the port's processor and ``TrainCollator`` as its data loader
would, and builds one train step (``train/step.py::make_train_step``) with
its shift and AdamW state.  It drives that step through its first three
steps, each on another batch, through the window's own feed and call; the
window then keeps stepping, cycling the batches, until ``--seconds`` have
passed.

What the window drives, and the reference works out again: the vision tower
and the connector on every image of both passes, the record pass's captured
MLP outputs at the paired query rows, the shift pass with μ·v, both losses,
the shift's gradient (through the backward kernels) and the update.
Compared: the first three steps' losses, the first gradient as the optimizer
took it (from its first moment after one step) and the shift's change after
three steps, each by its worst leaf.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.lib import gen, program, registry
from benchmark.lib.weights import make_shift, make_weights
from benchmark.reference import mimic, plain

FIRST_STEPS = 3
B1 = 0.9  # AdamW's first-moment decay (the program's and the reference's)


def raw_batches(cfg: Dict[str, Any], p: Dict[str, Any], seed: int) -> List[List[Dict[str, Any]]]:
    """The cell's distinct batches: per row an instruction and ``demos``
    question / answer pairs, each with an image, then the query with the last
    image.  Text lengths and image sizes are the workload's, permuted."""
    tpl = p["templates"]
    out = []
    for bi in range(p["distinct_batches"]):
        rng = gen.rng_for(seed, 1, bi)
        rows = []
        for r in range(p["batch_size"]):
            dq = gen.permuted(rng, p["demo_question_chars"])
            da = gen.permuted(rng, p["demo_answer_chars"])
            hw = gen.permuted(rng, [tuple(x) for x in p["image_sizes"]])[: p["demos"] + 1]
            demos = "".join(tpl["demo"].format(q=gen.question(rng, nq), a=gen.answer(rng, na))
                            for nq, na in zip(dq, da))
            rows.append(dict(
                prefix=tpl["instruction"].format(text=p["instruction"]) + demos,
                query=tpl["query"].format(q=gen.question(rng, p["query_question_chars"][r])),
                answer=gen.answer(rng, p["answer_chars"][r]),
                images=[gen.image(seed, bi * 1000 + r * 100 + i, x) for i, x in enumerate(hw)],
            ))
        out.append(rows)
    return out


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """The worst leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn = {k: float(prog[k].double().norm()) for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep)


def readings(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The compared numbers.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out."""
    gn = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(gn.values())))
    keep = [k for k, v in gn.items() if v >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss, "grad_gap": leaf_gap(prog["grad"], ref["grad"], keep),
            "change_gap": leaf_gap(prog["delta"], ref["delta"], keep)}


class Traffic:
    unit = "samples"

    def __init__(self, cfg, wl, seed, device, dtype, spans):
        self.cfg, self.p = cfg, wl["params"]
        self.seed, self.device, self.dtype, self.spans = seed, device, dtype, spans
        self.raw = raw_batches(cfg, self.p, seed)
        self.fam = registry.reference(cfg["family"])
        self.s = self.fam.sizes(cfg)

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from mimic_tpu_torch.config import get_preset
        from mimic_tpu_torch.train.collate import TrainCollator
        from mimic_tpu_torch.train.optim import build_optimizer
        from mimic_tpu_torch.train.step import TrainState, make_train_step, to_device_batch

        p, dev = self.p, self.device
        self.to_device = to_device_batch
        self.runner = program.build(self.cfg, make_weights(self.cfg, self.seed, dev, self.dtype),
                                    dev, self.dtype)
        enc, peft = get_preset(p["preset"])
        self.loss_w = {"ce": peft.ce_loss_weight, "align": peft.align_loss_weight}
        collator = TrainCollator(self.runner.processor, enc.strategy(),
                                 pad_multiple=p["pad_multiple"])
        self.host = [collator({"prefix_texts": [r["prefix"] for r in rows],
                               "query_texts": [r["query"] for r in rows],
                               "answers": [r["answer"] for r in rows],
                               "images": [r["images"] for r in rows]}) for rows in self.raw]
        for hb in self.host:
            got = (hb.full_ids.shape[1], hb.query_ids.shape[1])
            if got != (p["record_len"], p["shift_len"]):
                raise ValueError(f"passes of {got} tokens, the workload states "
                                 f"{(p['record_len'], p['shift_len'])}")
        self.work = [self.count(rows, hb.full_mask, hb.query_mask)
                     for rows, hb in zip(self.raw, self.host)]
        self.shift0 = make_shift(self.cfg, p["shift_init"], self.seed, dev)
        opt = p["optimizer"]
        trainable = {"shift": {k: v.clone() for k, v in self.shift0.items()}}
        tx = build_optimizer(trainable, lr=opt["lr"], weight_decay=opt["weight_decay"],
                             warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                             grad_clip=opt["grad_clip"])
        self.step = make_train_step(
            self.runner.cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
            align_loss_weight=peft.align_loss_weight, logz2="unmasked",
            attn_impl="flash" if dev.type == "cuda" else "xla")
        self.state = TrainState(trainable, tx.init(trainable), 0)
        self.frozen = self.runner.params
        self.n_steps, self.losses = 0, []
        for i in range(FIRST_STEPS):
            self.losses.append(self.one_step())
            if i == 0:
                mu = self.state.opt_state["mu"]  # keyed by leaf path
                self.first_grad = {k: mu[("shift", k)] / (1 - B1) for k in self.shift0}
        self.delta = {k: self.state.trainable["shift"][k].detach() - self.shift0[k]
                      for k in self.shift0}

    def count(self, rows, rec_key_ok, shift_key_ok) -> Dict[str, float]:
        """The work of one step on the raw ``rows``, whose passes have the key
        masks ``*_key_ok`` [B, T]: the record pass runs every image of a
        row, the shift pass its query image (the last)."""
        cfg, fam, s = self.cfg, self.fam, self.s

        def vit_rows(images):
            return [fam.vit_rows(im.shape[:2], cfg, s) for im in images]

        geo = dict(rec_key_ok=rec_key_ok, shift_key_ok=shift_key_ok,
                   rec_valid=np.array([n for r in rows for n in vit_rows(r["images"])]),
                   shift_valid=np.array([n for r in rows for n in vit_rows(r["images"][-1:])]),
                   ce_rows=float(shift_key_ok[:, 1:].sum()))
        return registry.flops(cfg["family"]).train_step(s, geo)

    def one_step(self) -> float:
        """The window's call and feed: the next batch to the card, one step,
        the loss read back (as a trainer logs it)."""
        with self.spans.span("step"):
            hb = self.host[self.n_steps % len(self.host)]
            batch = self.to_device(hb, self.device)
            self.state, m = self.step(self.state, self.frozen, batch)
            loss = float(m["loss"])
        self.n_steps += 1
        return loss

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> Dict[str, Any]:
        first, done = self.n_steps, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.one_step()
            done += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        B = self.p["batch_size"]
        work = {k: sum(self.work[(first + i) % len(self.work)][k] for i in range(done))
                for k in self.work[0]}
        work.update(units=done * B, steps=done)
        return {"elapsed": elapsed, "attempted": done * B, "failed": 0, "work": work,
                "end_to_end": {"train_samples_per_s": done * B / elapsed}}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("runner", "state", "step", "frozen", "host"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------------

    def program_readings(self) -> Dict[str, Any]:
        return {"losses": self.losses, "grad": self.first_grad, "delta": self.delta}

    def reference(self, prec: str = "fp32", rows=None) -> Dict[str, Any]:
        """The reference's first three steps on the same raw batches (``rows``:
        those rows of each batch only)."""
        weights = make_weights(self.cfg, self.seed, self.device, self.dtype)
        batches = [[b[r] for r in (rows or range(len(b)))] for b in self.raw[:FIRST_STEPS]]
        with plain.no_tf32():
            out = mimic.train(self.fam, self.cfg, weights, batches, self.shift0,
                              self.p["optimizer"], self.loss_w, self.p["pad_multiple"],
                              plain.Precision(prec), self.device)
        del weights
        return out

    def check(self) -> Dict[str, float]:
        return readings(self.program_readings(), self.reference())
