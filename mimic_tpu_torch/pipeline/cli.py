"""Command-line interface (counterpart of ``mimic_tpu/pipeline/cli.py``).

    python -m mimic_tpu_torch train   runname=exp model_name=idefics2-8b-base data.num_shot=16
    python -m mimic_tpu_torch eval    model_name=idefics2-8b-base ckpt_path=results/ckpt/.../epoch-9 preset=mimic quant=int8-w8a8
    python -m mimic_tpu_torch analyze prefix
    python -m mimic_tpu_torch pipeline -r exp -m idefics2-8b-base -d vqav2 -q 500 -s 16 -p mimic

Everything runs on the card; ``device=cpu`` (``train`` / ``eval``) or
``--device cpu`` (``pipeline``) asks for the CPU.  ``result_dir=DIR`` (or
``--result-dir``) names the results directory.  Models load the
``params.msgpack`` that ``python -m mimic_tpu_torch.models.convert`` wrote
under the model's path (``MIMIC_TPU_IDEFICS2_8B_BASE_PATH``,
``config/paths.py``), else they are built with random weights
(``models/factory.py``).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import torch

from ..config import EvalConfig, TrainConfig, apply_overrides, get_preset

# overrides that configure the run rather than a config field
_RUN_KEYS = ("preset", "device", "result_dir")


def _split_overrides(overrides: List[str]) -> Tuple[dict, List[str]]:
    """Take ``preset=``, ``device=`` and ``result_dir=`` out of ``overrides``."""
    run = {"preset": None, "device": None, "result_dir": "results"}
    rest = []
    for o in overrides:
        key, sep, value = o.partition("=")
        if sep and key in _RUN_KEYS:
            run[key] = value
        else:
            rest.append(o)
    return run, rest


def _train(overrides: List[str], splits=None):
    cfg = TrainConfig()
    run, overrides = _split_overrides(overrides)
    if run["preset"]:
        cfg.encoder, cfg.peft = get_preset(run["preset"])
    apply_overrides(cfg, overrides)
    from .train_entry import run_train

    return run_train(cfg, result_dir=run["result_dir"], splits=splits, device=run["device"])


def _eval(overrides: List[str], splits=None, runner=None):
    """``runner`` (tests, callers that keep a model alive) replaces the
    model built from ``cfg.model_name``; ``splits`` replaces the dataset
    files."""
    cfg = EvalConfig()
    run, overrides = _split_overrides(overrides)
    if run["preset"]:
        cfg.encoder, cfg.peft = get_preset(run["preset"])
    apply_overrides(cfg, overrides)
    from ..models.factory import build_model
    from .evaluate import run_eval
    from .runner import _load_ckpt_into_runner

    if runner is None:
        runner = build_model(cfg.model_name, cfg.data.name, device=run["device"],
                             dtype=getattr(torch, cfg.dtype))
    if not cfg.is_icl:
        _load_ckpt_into_runner(cfg, runner)
    if cfg.quant:
        # after the checkpoint load so the int8 copy reflects final weights
        runner.set_quant(cfg.quant)
    return run_eval(cfg, runner, result_dir=run["result_dir"], splits=splits)


def _analyze(args: List[str]):
    parser = argparse.ArgumentParser(prog="mimic_tpu_torch analyze")
    parser.add_argument("prefix")
    parser.add_argument("--result-dir", default="results")
    parser.add_argument("--metric-key", default=None)
    parser.add_argument("--topk", type=int, default=1)
    parser.add_argument("--verbose", action="store_true")
    ns = parser.parse_args(args)
    from .analyze import analyze

    return analyze(ns.prefix, ns.result_dir, ns.metric_key, ns.topk, ns.verbose)


def _pipeline(args: List[str], splits=None):
    parser = argparse.ArgumentParser(prog="mimic_tpu_torch pipeline")
    parser.add_argument("-r", "--runname", required=True)
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-d", "--datasets", nargs="+", default=["vqav2"])
    parser.add_argument("-q", "--num-query-samples", nargs="+", type=int, default=[500])
    parser.add_argument("-s", "--num-shots", nargs="+", type=int, default=[32])
    parser.add_argument("-p", "--preset", default="mimic")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-e", "--eval", action="store_true")
    parser.add_argument("-a", "--analyze", action="store_true")
    parser.add_argument("--result-dir", default="results")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(args)
    all_phases = not (ns.train or ns.eval or ns.analyze)
    from ..models.factory import build_model
    from .runner import PipelineSpec, run_pipeline

    spec = PipelineSpec(
        runname=ns.runname,
        model_name=ns.model,
        preset=ns.preset,
        datasets=ns.datasets,
        num_query_samples=ns.num_query_samples,
        num_shots=ns.num_shots,
        do_train=ns.train or all_phases,
        do_eval=ns.eval or all_phases,
        do_analyze=ns.analyze or all_phases,
    )
    runner = build_model(ns.model, ns.datasets[0], device=ns.device)
    return run_pipeline(spec, result_dir=ns.result_dir, runner=runner, splits=splits)


def main(argv: Optional[List[str]] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    command, rest = argv[0], argv[1:]
    if command == "train":
        _train(rest)
    elif command == "eval":
        _eval(rest)
    elif command == "analyze":
        _analyze(rest)
    elif command == "pipeline":
        _pipeline(rest)
    else:
        print(f"Unknown command {command!r}\n{__doc__}")
        sys.exit(2)


if __name__ == "__main__":
    main()
