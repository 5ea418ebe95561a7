"""Autoregressive generation: greedy, beam search and sampling.

Counterpart of ``mimic_tpu/models/generate.py`` (HF semantics: ``num_beams``,
``length_penalty``, early_stopping=False; ``temperature`` / ``top_k`` /
``top_p`` for sampling).  The JAX decode loop is one
``lax.scan`` over a fixed number of steps; here it is a Python loop over the
same steps.  Prompts must be left-padded so the last prompt position is
aligned across the batch.

Top-k selections use a stable descending sort, so among equal values the lower
index comes first, as with ``jax.lax.top_k``: the beam state holds many equal
``NEG`` slots, and ``torch.topk`` promises no order among ties.

Int8 serving: ``decode_params`` (the int8 copy of the ``"int8"`` mode) is
read by every decode step while the prefill reads ``params``; ``quant_kv``
stores the beam-shared prompt KV int8 (``ops/decode_attention.py``).

``image_feats``: encoded image features computed elsewhere (the runner's
``VisionFeatureCache``); the prefill then skips the vision tower.  The
prefill's features (idefics1: the cross-attention states) are reused by every
decode step; an idefics1 decode step attends the image of the last prompt
token (``_decode_image_rows``) and re-projects the cross k/v, as the JAX loop
does (there is no cross k/v cache).

``adapters`` / ``lora_scaling``: live LoRA adapters (``shift/lora.py``), read
by the prefill and every decode step.  ``prefix``: a prefix-tuning KV
(``shift/prefix.py``) whose P slots lead the timeline: the prefill writes the
prompt behind them through the decoder's prefix-merge path
(``prefix_flash_len``) and positions count from P.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..bridge import tree_leaves
from ..ops.decode_attention import quantize_prompt_kv
from .config import ModelConfig
from ..shift.prefix import prefix_forward_args, prefix_len
from .decoder import init_kv_cache
from .lvlm import LVLMBatch, encode_images, lvlm_forward

NEG = -1.0e9


# prompt-region length from which beam search stores the prompt KV int8 by
# default (kept from the JAX package, where it is a TPU measurement)
QUANT_KV_MIN_PROMPT = 1024


def _param_dtype(params) -> torch.dtype:
    """Model compute dtype: the first floating leaf that is not fp32 (int8
    weight tables and their fp32 scales do not define it)."""
    for leaf in tree_leaves(params):
        if leaf.is_floating_point() and leaf.dtype != torch.float32:
            return leaf.dtype
    return torch.float32


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties lower-index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,N,M], idx [B,J] → x[b, idx[b, j], :] as [B,J,M]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _decode_image_rows(batch: LVLMBatch, beams: int = 1) -> dict:
    """What a decode step's batch carries of the prompt's images (idefics1):
    the last prompt token's ``image_attention_mask`` row [B,1,N] and the
    ``pixel_mask``, each tiled per beam; nothing for the other families."""
    if batch.image_attention_mask is None:
        return {}
    rows = dict(image_attention_mask=batch.image_attention_mask[:, -1:, :],
                pixel_mask=batch.pixel_mask)
    return {k: None if v is None else v.repeat_interleave(beams, dim=0) for k, v in rows.items()}


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens], pad-filled after EOS
    scores: torch.Tensor  # [B] sequence scores (beam) or 0.0 (greedy)


def _prefill(
    params, cfg: ModelConfig, batch: LVLMBatch, total_len: int, shift, logz2: str,
    dtype, attn_impl: str = "xla", image_feats: Optional[torch.Tensor] = None,
    adapters=None, lora_scaling: float = 1.0, prefix=None,
):
    """Run the prompt through the model: a cache-empty prefill, or with a
    ``prefix`` a prefill into a cache whose slots ``[0, P)`` hold it
    (``total_len`` includes P).

    Returns (last_logits [B,V], cache with the prompt written, image_feats),
    the image features for the decode steps to reuse (``image_feats`` as
    given, else encoded from ``batch.pixel_values``).
    """
    B, T = batch.input_ids.shape
    if image_feats is None and batch.pixel_values is not None:
        image_feats = encode_images(
            params, cfg, batch.pixel_values, batch.patch_mask, attn_impl=attn_impl
        )
    if prefix is None:
        cache = init_kv_cache(cfg.text, B, total_len, batch.input_ids.device, dtype)
        extra = dict(kv_cache=cache, cache_empty=True)
    else:
        P = prefix_len(prefix)
        batch, pos, cache, _ = prefix_forward_args(
            prefix, batch, dtype, extra_len=total_len - P - T
        )
        extra = dict(kv_cache=cache, position_ids=pos, prefix_flash_len=P)
    out = lvlm_forward(
        params, cfg, batch,
        image_feats=image_feats,
        kv_total_len=total_len,
        shift=shift,
        adapters=adapters,
        lora_scaling=lora_scaling,
        logz2=logz2,
        attn_impl=attn_impl,
        last_logit_only=True,
        **extra,
    )
    # left padding → the last position is the prompt end
    return out.logits[:, -1], out.decoder.kv_cache, image_feats


@torch.no_grad()
def greedy_generate(
    params,
    cfg: ModelConfig,
    batch: LVLMBatch,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    shift: Optional[Dict[str, torch.Tensor]] = None,
    logz2: str = "unmasked",
    attn_impl: str = "xla",
    decode_params=None,
    image_feats: Optional[torch.Tensor] = None,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    lora_scaling: float = 1.0,
    prefix: Optional[Dict[str, torch.Tensor]] = None,
) -> GenerateResult:
    B, T = batch.input_ids.shape
    P = prefix_len(prefix)
    total = P + T + max_new_tokens
    dparams = decode_params if decode_params is not None else params
    dtype = _param_dtype(params)
    lora = dict(adapters=adapters, lora_scaling=lora_scaling)
    last_logits, cache, image_feats = _prefill(
        params, cfg, batch, total, shift, logz2, dtype, attn_impl, image_feats, prefix=prefix,
        **lora,
    )
    am = batch.attention_mask
    n_real = am.sum(-1)  # [B]
    mask_full = torch.cat([am.new_ones(B, P), am, am.new_zeros(B, max_new_tokens)], dim=-1)
    tok = last_logits.argmax(-1)
    finished = torch.zeros(B, dtype=torch.bool, device=am.device)
    images = _decode_image_rows(batch)
    toks = []
    for i in range(max_new_tokens):
        tok = torch.where(finished, pad_token_id, tok)
        mask_full[:, P + T + i] = 1
        out = lvlm_forward(
            dparams, cfg,
            LVLMBatch(input_ids=tok[:, None], attention_mask=mask_full, **images),
            image_feats=image_feats,
            position_ids=(n_real + P + i)[:, None],
            kv_cache=cache,
            kv_total_len=total,
            shift=shift,
            logz2=logz2,
            **lora,
        )
        cache = out.decoder.kv_cache
        finished = finished | (tok == eos_token_id)
        toks.append(tok)
        tok = torch.where(finished, pad_token_id, out.logits[:, -1].argmax(-1))
    return GenerateResult(
        tokens=torch.stack(toks, dim=1),
        scores=torch.zeros(B, dtype=torch.float32, device=am.device),
    )


@torch.no_grad()
def beam_generate(
    params,
    cfg: ModelConfig,
    batch: LVLMBatch,
    max_new_tokens: int,
    num_beams: int,
    eos_token_id: int,
    pad_token_id: int,
    length_penalty: float = 0.0,
    shift: Optional[Dict[str, torch.Tensor]] = None,
    logz2: str = "unmasked",
    attn_impl: str = "xla",
    decode_params=None,
    quant_kv: Optional[bool] = None,
    image_feats: Optional[torch.Tensor] = None,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    lora_scaling: float = 1.0,
    prefix: Optional[Dict[str, torch.Tensor]] = None,
) -> GenerateResult:
    """HF-semantics beam search (do_sample=False, early_stopping=False).

    The prompt region of the cache is identical across a row's beams (one
    prefill), so it is kept once at batch B (``prompt_k/v``, read with the
    beams folded into the query-group axis) and each beam holds only the thin
    generated region, which is all a beam reorder has to gather.

    ``quant_kv``: store that prompt region int8 and read it through the
    ``prompt_attn_int8`` kernel.  Default: on when ``decode_params`` is set
    and the prompt has at least ``QUANT_KV_MIN_PROMPT`` slots.  It runs only
    on CUDA, without a shift, a sliding window or a head dim off 128 (JAX's
    gate, with the card in the TPU's place); the prompt region is then
    zero-padded to a multiple of 128 slots, masked out in the timeline.

    ``prefix``: its P slots lead the beam-shared prompt region (Tp = P + T).
    """
    B, T = batch.input_ids.shape
    K = num_beams
    P = prefix_len(prefix)
    Tp = P + T
    total = Tp + max_new_tokens
    dparams = decode_params if decode_params is not None else params
    dtype = _param_dtype(params)
    lora = dict(adapters=adapters, lora_scaling=lora_scaling)
    last_logits, cache, image_feats = _prefill(
        params, cfg, batch, total, shift, logz2, dtype, attn_impl, image_feats, prefix=prefix,
        **lora,
    )
    V = last_logits.shape[-1]
    dev = last_logits.device

    L, _, _, Hkv, Dh = cache["k"].shape
    gen_shape = (L, B * K, max_new_tokens, Hkv, Dh)
    prompt_k, prompt_v = cache["k"][:, :, :Tp], cache["v"][:, :, :Tp]
    if quant_kv is None:
        quant_kv = decode_params is not None and Tp >= QUANT_KV_MIN_PROMPT
    # Tq: the prompt region's length in the decode timeline (128-padded when int8)
    Tq = Tp
    cache_len = cache["length"]
    if (quant_kv and shift is None and cfg.text.sliding_window is None and Dh % 128 == 0
            and dev.type == "cuda"):
        Tq = ((Tp + 127) // 128) * 128
        cache_len = cache_len + (Tq - Tp)
        prompt_k, prompt_v = quantize_prompt_kv(prompt_k, prompt_v, padded_len=Tq)
    total = Tq + max_new_tokens
    cache = {
        "prompt_k": prompt_k,
        "prompt_v": prompt_v,
        "k": torch.zeros(gen_shape, dtype=cache["k"].dtype, device=dev),
        "v": torch.zeros(gen_shape, dtype=cache["v"].dtype, device=dev),
        "length": cache_len,
    }
    if image_feats is not None:
        image_feats = image_feats.repeat_interleave(K, dim=0)
    images = _decode_image_rows(batch, K)
    am = batch.attention_mask
    n_real = am.sum(-1).repeat_interleave(K)  # [B*K]
    # the prefix slots, the prompt, (Tq - Tp) masked prompt-pad columns, then
    # the generated region
    mask_full = torch.cat(
        [am.new_ones(B, P), am, am.new_zeros(B, total - Tp)], dim=-1
    ).repeat_interleave(K, dim=0)

    logprobs0 = F.log_softmax(last_logits.float(), dim=-1)  # [B,V]
    first_scores, first_toks = _top_k(logprobs0, K)  # [B,K]

    tokens = torch.full((B, K, max_new_tokens), pad_token_id, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = first_toks
    last_tok = first_toks
    scores = first_scores
    lengths = torch.ones(B, K, dtype=torch.int64, device=dev)
    alive = torch.ones(B, K, dtype=torch.bool, device=dev)
    fin_tokens = torch.full_like(tokens, pad_token_id)
    fin_scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)

    # move beams whose first token is EOS into the finished set
    is_eos = alive & (last_tok == eos_token_id)
    pen = scores / (lengths.float() ** length_penalty)
    all_fin_scores = torch.cat([fin_scores, torch.where(is_eos, pen, NEG)], dim=1)
    all_fin_tokens = torch.cat([fin_tokens, tokens], dim=1)
    fin_scores, top_idx = _top_k(all_fin_scores, K)
    fin_tokens = _take_rows(all_fin_tokens, top_idx)
    alive = alive & ~is_eos
    scores = torch.where(is_eos, NEG, scores)

    for i in range(1, max_new_tokens):
        mask_full[:, Tq + i - 1] = 1
        out = lvlm_forward(
            dparams, cfg,
            LVLMBatch(input_ids=last_tok.reshape(B * K)[:, None], attention_mask=mask_full,
                      **images),
            image_feats=image_feats,
            position_ids=(n_real + P + i - 1)[:, None],
            kv_cache=cache,
            kv_total_len=total,
            shift=shift,
            logz2=logz2,
            **lora,
        )
        logprobs = F.log_softmax(out.logits[:, -1].float(), dim=-1).reshape(B, K, V)
        cand = torch.where(alive[..., None], scores[..., None] + logprobs, NEG)
        top_scores, top_flat = _top_k(cand.reshape(B, K * V), 2 * K)  # [B,2K]
        parent = top_flat // V
        tok = top_flat % V

        # the K running beams are the top K non-EOS among the 2K candidates
        is_eos_cand = tok == eos_token_id
        _, keep_idx = _top_k(torch.where(is_eos_cand, NEG, top_scores), K)
        run_parent = torch.gather(parent, 1, keep_idx)
        run_tok = torch.gather(tok, 1, keep_idx)
        run_scores = torch.gather(top_scores, 1, keep_idx)
        run_alive = run_scores > NEG / 2

        # EOS candidates finish directly (their sequence = parent's tokens + EOS)
        eos_tokens = _take_rows(tokens, parent)
        eos_tokens[:, :, i] = eos_token_id
        eos_len = torch.gather(lengths, 1, parent) + 1
        eos_pen = torch.where(is_eos_cand, top_scores, NEG) / (eos_len.float() ** length_penalty)
        eos_pen = torch.where(is_eos_cand, eos_pen, NEG)
        fin_scores, fin_idx = _top_k(torch.cat([fin_scores, eos_pen], dim=1), K)
        fin_tokens = _take_rows(torch.cat([fin_tokens, eos_tokens], dim=1), fin_idx)

        # reorder the running state by parent beam; only the generated region
        # of the cache is per-beam, the shared prompt region never moves
        tokens = _take_rows(tokens, run_parent)
        tokens[:, :, i] = run_tok
        flat_parent = (torch.arange(B, device=dev)[:, None] * K + run_parent).reshape(B * K)
        step_cache = out.decoder.kv_cache
        cache = {
            "prompt_k": step_cache["prompt_k"],
            "prompt_v": step_cache["prompt_v"],
            "k": step_cache["k"].index_select(1, flat_parent),
            "v": step_cache["v"].index_select(1, flat_parent),
            "length": step_cache["length"],
        }
        lengths = torch.gather(lengths, 1, run_parent) + 1
        last_tok = run_tok
        scores = torch.where(run_alive, run_scores, NEG)
        alive = run_alive

    # close out still-running beams at max length
    run_pen = torch.where(alive, scores / (lengths.float() ** length_penalty), NEG)
    best_scores, best_idx = _top_k(torch.cat([fin_scores, run_pen], dim=1), 1)
    best_tokens = _take_rows(torch.cat([fin_tokens, tokens], dim=1), best_idx)[:, 0]
    return GenerateResult(tokens=best_tokens, scores=best_scores[:, 0])


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise [shape] in fp32 on the generator's device: the
    draw behind ``jax.random.categorical`` (argmax of logits + Gumbel noise),
    kept in one function so that a test can hand in the noise JAX drew."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def process_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """HF's order of logits processing: temperature, then top-k, then top-p.
    Filtered entries become ``NEG`` (not ``-inf``); the top-k comparison
    ``x < kth`` keeps ties with the k-th value; top-p keeps a token while the
    probability mass before it is at most ``top_p`` (HF's inclusive rule: the
    most likely token always survives)."""
    # by a tensor: CUDA turns a division by a Python scalar into a multiply
    x = logits.float() / torch.tensor(max(temperature, 1e-6), device=logits.device)
    V = x.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, NEG, x)
    if top_p < 1.0:
        sorted_x, sort_idx = torch.sort(x, dim=-1, descending=True, stable=True)
        probs = torch.softmax(sorted_x, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) <= top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
        x = torch.where(keep, x, NEG)
    return x


@torch.no_grad()
def sample_generate(
    params,
    cfg: ModelConfig,
    batch: LVLMBatch,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    shift: Optional[Dict[str, torch.Tensor]] = None,
    logz2: str = "unmasked",
    attn_impl: str = "xla",
    decode_params=None,
    image_feats: Optional[torch.Tensor] = None,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    lora_scaling: float = 1.0,
    prefix: Optional[Dict[str, torch.Tensor]] = None,
) -> GenerateResult:
    """Ancestral sampling (``do_sample=True``): each step processes the last
    logits (``process_logits``) and draws one token per row as the argmax of
    the processed logits plus ``gumbel`` noise from ``generator``, one draw
    per step, the prefill's first.  ``top_k=0`` / ``top_p=1.0`` disable their
    filters.  ``scores`` is the sum of the sampled tokens' log-probabilities
    under the processed logits; finished rows emit ``pad_token_id``.  As in
    the JAX loop, every one of the ``max_new_tokens`` steps runs a decode
    forward and draws, the last draw unused but scored.
    """
    B, T = batch.input_ids.shape
    P = prefix_len(prefix)
    total = P + T + max_new_tokens
    dparams = decode_params if decode_params is not None else params
    dtype = _param_dtype(params)
    lora = dict(adapters=adapters, lora_scaling=lora_scaling)
    last_logits, cache, image_feats = _prefill(
        params, cfg, batch, total, shift, logz2, dtype, attn_impl, image_feats, prefix=prefix,
        **lora,
    )

    def draw(logits):
        x = process_logits(logits, temperature, top_k, top_p)
        tok = (x + gumbel(generator, x.shape).to(x.device)).argmax(-1)
        lp = torch.gather(torch.log_softmax(x, dim=-1), 1, tok[:, None])[:, 0]
        return tok, lp

    am = batch.attention_mask
    n_real = am.sum(-1)
    mask_full = torch.cat([am.new_ones(B, P), am, am.new_zeros(B, max_new_tokens)], dim=-1)
    tok, lp_sum = draw(last_logits)
    finished = torch.zeros(B, dtype=torch.bool, device=am.device)
    images = _decode_image_rows(batch)
    toks = []
    for i in range(max_new_tokens):
        tok = torch.where(finished, pad_token_id, tok)
        mask_full[:, P + T + i] = 1
        out = lvlm_forward(
            dparams, cfg,
            LVLMBatch(input_ids=tok[:, None], attention_mask=mask_full, **images),
            image_feats=image_feats,
            position_ids=(n_real + P + i)[:, None],
            kv_cache=cache,
            kv_total_len=total,
            shift=shift,
            logz2=logz2,
            **lora,
        )
        cache = out.decoder.kv_cache
        finished = finished | (tok == eos_token_id)
        toks.append(tok)
        next_tok, lp = draw(out.logits[:, -1])
        lp_sum = lp_sum + torch.where(finished, 0.0, lp)
        tok = torch.where(finished, pad_token_id, next_tok)
    return GenerateResult(tokens=torch.stack(toks, dim=1), scores=lp_sum)
