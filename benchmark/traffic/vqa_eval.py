"""Traffic kind ``vqa_eval``: the beam-search VQA eval of a trained shift, in
whole calls of ``LVLMRunner.generate``, back to back (a closed loop).

Set-up makes a pool of calls from the seed: each question one COCO-like
image and a VQAv2-style question in the eval's prompt template (the
question lengths and image sizes of the workload file, permuted), then
builds the port's runner on the cell's weights with a MimIC shift whose gate
is open, as a trained one's is, and warms up one call.  The window runs the
pool's calls in turn until ``--seconds`` have passed.

The runner pads as it does by default (left, to a multiple of
``pad_multiple``), encodes the images, prefills through the attention
kernels with the shift and decodes through the cache.  The benchmark reads
what ``generate`` decodes from: the beam search's tokens and sequence scores
(the runner's ``beam_generate`` wrapped, the program unchanged).

Compared, on a sample of the window's questions drawn from the seed with the
longest prompt in it: each served sequence's score (the sum of its tokens'
log-probabilities, length penalty 0) against the reference's, which works
out the pixels, patch masks, ids and padding again from the raw image and
text and runs the model over the prompt and the served tokens.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.lib import gen, program, registry
from benchmark.lib.weights import make_shift, make_weights
from benchmark.reference import mimic, plain


def raw_calls(cfg: Dict[str, Any], p: Dict[str, Any], seed: int) -> List[Dict[str, Any]]:
    out = []
    for c in range(p["pool_calls"]):
        rng = gen.rng_for(seed, 2, c)
        lens = gen.permuted(rng, p["question_chars"])
        hw = gen.permuted(rng, [tuple(x) for x in p["image_sizes"]])
        out.append(dict(
            texts=[p["template"].format(instruction=p["instruction"], q=gen.question(rng, n))
                   for n in lens],
            images=[[gen.image(seed, c * 1000 + j, x)] for j, x in enumerate(hw)],
        ))
    return out


class _TimedProcessor:
    """The runner's processor inside a span (the traced run only)."""

    def __init__(self, inner, spans):
        self.inner, self.spans = inner, spans

    def __call__(self, *args, **kwargs):
        with self.spans.span("processor"):
            return self.inner(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Traffic:
    unit = "questions"

    def __init__(self, cfg, wl, seed, device, dtype, spans):
        self.cfg, self.p = cfg, wl["params"]
        self.seed, self.device, self.dtype, self.spans = seed, device, dtype, spans
        self.calls = raw_calls(cfg, self.p, seed)
        self.fam = registry.reference(cfg["family"])
        self.s = self.fam.sizes(cfg)
        self.widths = [plain.round_up(max(self.prompt_lengths(call)), self.p["pad_multiple"])
                       for call in self.calls]

    def prompt_lengths(self, call) -> List[int]:
        """Each question's prompt in tokens, its image expanded."""
        return [len(plain.encode(self.fam.expand(t, [im[0].shape[:2]], self.cfg, self.s)))
                for t, im in zip(call["texts"], call["images"])]

    def setup(self) -> None:
        import mimic_tpu_torch.models.runner as runner_mod

        p, dev = self.p, self.device
        self.runner = program.build(self.cfg, make_weights(self.cfg, self.seed, dev, self.dtype),
                                    dev, self.dtype, pad_multiple=p["pad_multiple"])
        self.shift = make_shift(self.cfg, p["shift_init"], self.seed, dev)
        self.runner.set_shift(self.shift)
        if self.spans.traced:
            self.runner.processor = _TimedProcessor(self.runner.processor, self.spans)
        self.runner_mod, self.beam = runner_mod, runner_mod.beam_generate

        def capture(*args, **kwargs):
            self.last = self.beam(*args, **kwargs)
            return self.last

        runner_mod.beam_generate = capture
        self.work = [self.count(i) for i in range(len(self.calls))]
        self.results: List[Any] = []
        self.one_call(0)                       # warm-up: every shape of the window
        self.results.clear()

    def count(self, i: int) -> Dict[str, float]:
        cfg, s = self.cfg, self.s
        call, width = self.calls[i], self.widths[i]
        ok = np.zeros((len(call["texts"]), width), bool)
        for b, n in enumerate(self.prompt_lengths(call)):
            ok[b, width - n:] = True
        valid = [self.fam.vit_rows(im[0].shape[:2], cfg, s) for im in call["images"]]
        geo = dict(prompt_key_ok=ok, valid=valid, beams=self.p["num_beams"],
                   new_tokens=self.p["max_new_tokens"])
        return registry.flops(cfg["family"]).eval_call(s, geo)

    def one_call(self, i: int) -> None:
        call = self.calls[i]
        with self.spans.span("generate"):
            self.runner.generate(call["images"], call["texts"], num_beams=self.p["num_beams"],
                                 max_new_tokens=self.p["max_new_tokens"])
        self.results.append((i, self.last.tokens, self.last.scores))

    def window(self, seconds: float) -> Dict[str, Any]:
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.one_call(done % len(self.calls))
            done += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        Q = self.p["questions_per_call"]
        failed = sum(Q - int(tok.shape[0]) for _, tok, _ in self.results)
        work = {k: sum(self.work[i % len(self.work)][k] for i in range(done)) for k in self.work[0]}
        work.update(units=done * Q, calls=done)
        return {"elapsed": elapsed, "attempted": done * Q, "failed": failed, "work": work,
                "end_to_end": {"eval_questions_per_s": (done * Q - failed) / elapsed}}

    def release(self) -> None:
        self.runner_mod.beam_generate = self.beam
        self.runner = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------------

    def sample(self) -> List[tuple]:
        """(call, question) pairs of the window's distinct calls, drawn from the
        seed, with the call's longest prompt first."""
        seen = {}
        for i, tok, sc in self.results:
            seen.setdefault(i, (tok.cpu(), sc.cpu()))
        pairs = [(i, j) for i in sorted(seen) for j in range(seen[i][0].shape[0])]
        if not pairs:
            return []
        first = min(seen)
        lens = [len(t) for t in self.calls[first]["texts"]]
        longest = (first, int(np.argmax(lens)))
        rest = [x for x in pairs if x != longest]
        rng = gen.rng_for(self.seed, 3)
        k = min(self.p["sample_questions"] - 1, len(rest))
        picked = [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
        self.served = seen
        return [longest] + picked

    def served_tokens(self, i: int, j: int) -> List[int]:
        row = [int(x) for x in self.served[i][0][j]]
        eos = plain.EOS
        return row[: row.index(eos) + 1] if eos in row else row

    def program_readings(self) -> Dict[str, Any]:
        """The served sequences and their scores, as the program reported them."""
        if not hasattr(self, "picks"):
            self.picks = self.sample()
        return {"sums": [float(self.served[i][1][j]) for i, j in self.picks],
                "tokens": [self.served_tokens(i, j) for i, j in self.picks]}

    def reference(self, prec: str = "fp32") -> Dict[str, Any]:
        """The reference's next-token log-probabilities at each served position
        of each sampled question (None where a served token is out of the
        vocabulary), beside the served tokens."""
        if not hasattr(self, "picks"):
            self.picks = self.sample()
        weights = make_weights(self.cfg, self.seed, self.device, self.dtype)
        shift = make_shift(self.cfg, self.p["shift_init"], self.seed, self.device)
        V = self.s["V"]
        rows, served = [], []
        with plain.no_tf32():
            for i, j in self.picks:
                toks = self.served_tokens(i, j)
                served.append(toks)
                if not toks or min(toks) < 0 or max(toks) >= V:
                    rows.append(None)
                    continue
                rows.append(mimic.beam_logprobs(
                    self.fam, self.cfg, weights, shift, self.calls[i]["texts"][j],
                    self.calls[i]["images"][j][0], self.widths[i], toks,
                    plain.Precision(prec), self.device))
        del weights
        return {"rows": rows, "served": served}

    def check(self) -> Dict[str, float]:
        return readings(self.program_readings(), self.reference())


def as_program(out: Dict[str, Any]) -> Dict[str, Any]:
    """A reference's output put in the program's place: the score it gives
    the served tokens, and the token it puts first at each position."""
    return {"sums": [None if r is None else float(r[range(len(t)), t].sum())
                     for r, t in zip(out["rows"], out["served"])],
            "tokens": [None if r is None else r.argmax(-1).tolist() for r in out["rows"]]}


def readings(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """``score_gap``: the widest gap between a served sequence's score and the
    reference's score of the same tokens.  ``token_rank``: the worst rank
    (0 = the reference's first choice) of a served token among the
    reference's next-token log-probabilities at its position.  Infinite where
    the reference has nothing to compare, or nothing was sampled."""
    gaps, ranks = [], []
    for p_sum, p_tok, r, served in zip(prog["sums"], prog["tokens"], ref["rows"], ref["served"]):
        if r is None or p_sum is None:
            gaps.append(float("inf"))
            ranks.append(float("inf"))
            continue
        pos = range(len(served))
        gaps.append(abs(p_sum - float(r[pos, served].sum())))
        chosen = r[range(len(p_tok)), p_tok]
        ranks.append(float((r[: len(p_tok)] > chosen[:, None]).sum(-1).max()))
    inf = float("inf")
    return {"score_gap": max(gaps, default=inf), "token_rank": max(ranks, default=inf)}
