"""Canonical run naming, parity with reference ``src/utils.py:119-143``."""

from __future__ import annotations

import os
from typing import Optional


def get_expand_runname(cfg) -> str:
    """Expand a config into its canonical run name.

    - training: ``{runname}-{model}-{dataset}-{num_query_samples}[-{num_shot}shot]``
      (the shot suffix is omitted when ``num_shot == 0``, i.e. plain PEFT)
    - analyze: basename of ``record_dir``
    - eval from checkpoint: basename of the run directory containing the epoch dir
    - eval ICL: ``icl-{model}-{dataset}``
    """
    if hasattr(cfg, "runname") and getattr(cfg, "runname", None) is not None:
        if cfg.data.num_shot == 0:
            return f"{cfg.runname}-{cfg.model_name}-{cfg.data.name}-{cfg.data.num_query_samples}"
        return (
            f"{cfg.runname}-{cfg.model_name}-{cfg.data.name}-"
            f"{cfg.data.num_query_samples}-{cfg.data.num_shot}shot"
        )

    record_dir: Optional[str] = getattr(cfg, "record_dir", None)
    if record_dir:
        return os.path.basename(record_dir)

    ckpt_path: Optional[str] = getattr(cfg, "ckpt_path", None)
    if ckpt_path:
        # checkpoint dir format: path/to/{expand-runname}/epoch-{epoch}
        return os.path.basename(os.path.dirname(ckpt_path))
    return f"icl-{cfg.model_name}-{cfg.data.name}"
