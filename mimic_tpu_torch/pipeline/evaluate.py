"""Evaluation entry (counterpart of ``mimic_tpu/pipeline/evaluate.py``) —
parity with reference ``src/eval.py``.

- ICL mode iff no checkpoint path is given (``eval.py:24``)
- record path ``<result_dir>/record/<runname>/{N}shot.json`` (ICL) or
  ``epoch-N.json`` (checkpoint) (``eval.py:26-39``)
- resume-skip when the record exists (``eval.py:43-46``)
- shifts stay active for all generation once loaded (``eval.py:52-61``)
- records persist {eval_result, records, configs} (``eval.py:67-79``)
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..config import EvalConfig, config_to_dict
from ..data.adapters import build_adapter
from ..utils import get_expand_runname


def record_path(cfg: EvalConfig, result_dir: str) -> str:
    runname = get_expand_runname(cfg)
    record_dir = os.path.join(result_dir, "record", runname)
    if cfg.is_icl:
        fname = f"{cfg.data.num_shot}shot.json"
    else:
        epoch = os.path.basename(cfg.ckpt_path)  # "epoch-N"
        fname = f"{epoch}.json"
    return os.path.join(record_dir, fname)


def save_record(path: str, eval_result: Dict, records, train_cfg: Optional[Dict], eval_cfg: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "eval_result": eval_result,
        "records": records,
        "train_config": train_cfg,
        "eval_config": eval_cfg,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


def _default_shard() -> Tuple[int, int]:
    """One process on one card: multi-host sharding is asked for explicitly
    (``shard=(rank, num_replicas)``) until the port has a mesh."""
    return 0, 1


def _atomic_json(path: str, payload) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, default=str)
    os.replace(tmp, path)


def _interleave(parts: List[List]) -> List:
    """Round-robin merge of per-rank lists back into single-host query order
    (rank r evaluated queries r, r+R, r+2R, …)."""
    merged = []
    for i in range(max((len(p) for p in parts), default=0)):
        for p in parts:
            if i < len(p):
                merged.append(p[i])
    return merged


def _merge_shards(path: str, num_replicas: int, timeout: float) -> List[Dict]:
    """Rank 0: wait for every rank's part file, load them in rank order."""
    paths = [f"{path}.part-{r}-of-{num_replicas}" for r in range(num_replicas)]
    deadline = time.time() + timeout
    while any(not os.path.exists(p) for p in paths):
        if time.time() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise TimeoutError(f"eval shard merge: missing parts {missing}")
        time.sleep(0.2)
    parts = [json.load(open(p)) for p in paths]
    for p in paths:
        os.remove(p)
    return parts


def run_eval(
    cfg: EvalConfig,
    runner,
    result_dir: str = "results",
    adapter=None,
    splits=None,
    shard: Optional[Tuple[int, int]] = None,
    shard_merge_timeout: float = 3600.0,
) -> Optional[Tuple[Any, Dict]]:
    """Evaluate ``runner`` on the configured dataset; returns (records, metrics) or
    None when the record already exists and resume is on.

    Multi-host: ``shard=(rank, num_replicas)`` (default ``(0, 1)``)
    splits the query set across hosts within this one task — the eval analog of
    ``train_entry``'s per-host sharding (the reference leaves extra GPUs idle
    during a single eval task, ``src/pipeline.py:169-227`` farms whole tasks
    only).  Non-zero ranks write a part file and return None; rank 0 waits for
    all parts, merges records and metric rows in query order, computes the
    final metrics, and persists the single combined record."""
    cfg.data.is_icl = cfg.is_icl
    path = record_path(cfg, result_dir)
    if cfg.resume and os.path.exists(path):
        print(f"Record {path} exists, skipping.")
        return None

    if adapter is None:
        adapter = build_adapter(cfg.data, splits=splits)

    if cfg.data.length_buckets and hasattr(runner, "length_buckets"):
        runner.length_buckets = tuple(cfg.data.length_buckets)

    if not cfg.is_icl:
        if (
            runner.shift is None
            and runner.adapters is None
            and getattr(runner, "prefix", None) is None
            and not getattr(runner, "_lora_merged", False)
        ):
            raise ValueError(
                "Non-ICL eval requires the runner to carry trained parameters "
                "(shift/LoRA/prefix — use load_trainable + runner.set_shift "
                "before run_eval, or pass a template via EvalConfig and let "
                "the caller load it)."
            )

    rank, num_replicas = shard if shard is not None else _default_shard()
    if num_replicas > 1:
        adapter.set_eval_shard(rank, num_replicas)

    # vision-feature cache: the ICL protocol's fixed support images encode
    # once per eval instead of once per occurrence (bit-exact; measured
    # 13.7 → 18.9 q/s, BASELINE.md round 5).  idefics1 cross-attention is
    # excluded by the runner itself.
    if (
        getattr(cfg, "vision_cache", False)
        and hasattr(runner, "enable_vision_cache")
        and getattr(runner, "vision_cache", None) is None
        and runner.cfg.family != "idefics1"
    ):
        runner.enable_vision_cache(
            max_bytes=getattr(cfg, "vision_cache_mb", 512) * 1024 * 1024
        )

    records, eval_result = adapter.eval(cfg, runner)

    if num_replicas > 1:
        # eval_result is the un-computed Metric (rows intact); merge across hosts
        metric = eval_result
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_json(
            f"{path}.part-{rank}-of-{num_replicas}",
            {"records": records, "rows": metric.rows},
        )
        if rank != 0:
            return None
        parts = _merge_shards(path, num_replicas, shard_merge_timeout)
        records = _interleave([p["records"] for p in parts])
        metric.load_rows(_interleave([p["rows"] for p in parts]))
        eval_result = metric.compute()

    train_cfg = None
    if cfg.ckpt_path:
        cfg_file = os.path.join(os.path.dirname(cfg.ckpt_path), "config.json")
        if os.path.exists(cfg_file):
            train_cfg = json.load(open(cfg_file))
    save_record(path, eval_result, records, train_cfg, config_to_dict(cfg))
    return records, eval_result
