"""What a cell's reference computes: MimIC's train steps, and the score of a
served beam.  Any family: ``benchmark/reference/<family>.py`` (``fam``
below) supplies the sizes, the image path, the token expansion and the text
tower; the losses, the optimizer and the tokenizer are ``plain``.

Inputs are the raw ones a cell made (uint8 images, strings); the reference
tokenises, pads, collates and preprocesses them itself.  Weights are made
again from the seed by the benchmark and read in bf16, each product taken in
float32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import plain

Tree = Dict[str, Any]


def _images(fam, cfg, s, images: Sequence[np.ndarray], device):
    out = []
    for img in images:
        px, mask = fam.process_image(img, cfg, s)
        out.append((torch.from_numpy(px).to(device),
                    None if mask is None else torch.from_numpy(mask).to(device)))
    return out


def _hw(images) -> List[tuple]:
    return [tuple(im.shape[:2]) for im in images]


def collate(fam, cfg, s, rows: List[Dict[str, Any]], pad_multiple: int):
    """The dual-pass batch of MimIC's collator, worked out from the raw rows:
    shift pass ``query <pad> answer </s>`` (the query image), record pass
    ``prefix <pad> query <pad> answer </s>`` (every image; each ``<image>``
    expanded to the tokens of its own image), right-padded to a
    multiple of ``pad_multiple``; masks are ``id != <pad>`` (the separators
    drop out); the paired rows are the record pass's tokens after its first
    separator and the shift pass's tokens but BOS."""
    shift = [plain.encode(fam.expand(r["query"] + "<pad>" + r["answer"] + "</s>",
                                     _hw(r["images"][-1:]), cfg, s)) for r in rows]
    full = [plain.encode(fam.expand(r["prefix"] + "<pad>" + r["query"] + "<pad>"
                                    + r["answer"] + "</s>", _hw(r["images"]), cfg, s))
            for r in rows]
    q_ids, _ = plain.pad_rows(shift, plain.round_up(max(map(len, shift)), pad_multiple), "right")
    f_ids, _ = plain.pad_rows(full, plain.round_up(max(map(len, full)), pad_multiple), "right")
    q_sel = (q_ids != plain.PAD) & (q_ids != plain.BOS)
    f_sel = np.zeros_like(f_ids, bool)
    for b in range(len(rows)):
        sep = int(np.nonzero(f_ids[b] == plain.PAD)[0][0])
        f_sel[b, sep + 1:] = f_ids[b, sep + 1:] != plain.PAD
    M = int(max(q_sel.sum(1).max(), f_sel.sum(1).max()))

    def gather(sel):
        idx = np.zeros((len(rows), M), np.int64)
        valid = np.zeros((len(rows), M), bool)
        for b in range(len(rows)):
            pos = np.nonzero(sel[b])[0]
            idx[b, :len(pos)], valid[b, :len(pos)] = pos, True
        return idx, valid

    f_idx, f_valid = gather(f_sel)
    q_idx, q_valid = gather(q_sel)
    if not np.array_equal(f_valid, q_valid):
        raise ValueError("the passes' query rows do not pair")
    return dict(q_ids=q_ids, f_ids=f_ids, f_idx=f_idx, q_idx=q_idx, valid=q_valid)


def _embed(fam, cfg, s, params, ids: torch.Tensor, images, prec) -> torch.Tensor:
    embeds = params["lm"]["embed"][ids].float()
    feats = [[fam.encode_image(params, cfg, s, px, m, prec) for px, m in row] for row in images]
    return plain.splice(embeds, ids, feats)


def train(fam, cfg: Dict[str, Any], params: Tree, raw_batches: List[List[Dict[str, Any]]],
          shift0: Tree, opt: Dict[str, Any], loss_w: Dict[str, float], pad_multiple: int,
          prec: plain.Precision, device) -> Dict[str, Any]:
    """MimIC steps from ``shift0`` over ``raw_batches``: the record pass (no
    shift, no gradient, MLP outputs at the paired rows), the shift pass
    (shift in, the same outputs and the logits), loss = ce·CE + align·MSE, its
    gradient to the shift, AdamW.  Returns each step's loss, the first step's
    gradient as the optimizer takes it (clipped) and the shift's change."""
    s = fam.sizes(cfg)
    shift = {k: v.detach().float().clone() for k, v in shift0.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in shift.items()},
             "nu": {k: torch.zeros_like(v) for k, v in shift.items()}}
    losses, first = [], None
    for rows in raw_batches:
        c = collate(fam, cfg, s, rows, pad_multiple)
        t = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
        with torch.no_grad():
            full_imgs = [_images(fam, cfg, s, r["images"], device) for r in rows]
            emb = _embed(fam, cfg, s, params, t["f_ids"], full_imgs, prec)
            _, rec = fam.decoder(params, s, cfg, emb, t["f_ids"] != plain.PAD, None, None,
                                 t["f_idx"], prec)
            del emb
            q_imgs = [[imgs[-1]] for imgs in full_imgs]
            emb = _embed(fam, cfg, s, params, t["q_ids"], q_imgs, prec)
        leaves = {k: v.clone().requires_grad_(True) for k, v in shift.items()}
        with torch.enable_grad():
            h, caps = fam.decoder(params, s, cfg, emb, t["q_ids"] != plain.PAD, leaves, None,
                                  t["q_idx"], prec, remat=True)
            logits = prec.mm(h, params["lm"]["lm_head"])
            loss = (loss_w["ce"] * plain.ce_loss(logits, t["q_ids"], t["q_ids"] != plain.PAD)
                    + loss_w["align"] * plain.mse_loss(caps, rec, t["valid"]))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        shift, state, g = plain.adamw(shift, dict(zip(leaves, grads)), state, opt)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.detach().clone() for k, v in g.items()}
        del h, caps, logits, rec, emb
    return {"losses": losses, "grad": first,
            "delta": {k: shift[k] - shift0[k].float() for k in shift}}


def beam_logprobs(fam, cfg: Dict[str, Any], params: Tree, shift: Optional[Tree], prompt: str,
                  image: np.ndarray, width: int, tokens: Sequence[int],
                  prec: plain.Precision, device) -> torch.Tensor:
    """Log-probabilities [len(tokens), V] of the next token at each served
    position: the prompt left-padded to ``width`` as its call was, its image,
    the served tokens before that position.  Prompt rows take log Z2 over the
    padded prompt; a generated row over the keys up to its own (what
    generation with a cache sees)."""
    s = fam.sizes(cfg)
    ids = plain.encode(fam.expand(prompt, _hw([image]), cfg, s))
    n_pad = width - len(ids)
    seq = [plain.PAD] * n_pad + ids + list(tokens[:-1])
    ok = [0] * n_pad + [1] * (len(seq) - n_pad)
    T = len(seq)
    u_len = torch.tensor([width if t < width else t + 1 for t in range(T)], device=device)
    ids_t = torch.tensor([seq], device=device)
    imgs = [_images(fam, cfg, s, [image], device)]
    with torch.no_grad():
        emb = _embed(fam, cfg, s, params, ids_t, imgs, prec)
        h, _ = fam.decoder(params, s, cfg, emb, torch.tensor([ok], device=device) > 0, shift,
                           u_len, None, prec)
        rows = h[0, width - 1: width - 1 + len(tokens)]
        return torch.log_softmax(prec.mm(rows, params["lm"]["lm_head"]), -1).cpu()
