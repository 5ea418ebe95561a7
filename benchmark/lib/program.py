"""The system under test: ``mimic_tpu_torch`` (imported only here and in the
traffic files, never by the reference).

``build`` hands the benchmark's weights to the port's ``build_model`` and
checks that the port's architecture for the model is the configuration
file's, so that the program and the reference run the same model.
"""

from __future__ import annotations

from typing import Any, Dict

from . import registry
from .family import Defaulted


def check_architecture(pcfg, cfg: Dict[str, Any]) -> None:
    """Raise unless the port's ``ModelConfig`` is the configuration file's:
    each key of the family's ``expect`` (``reference/<family>.py``)."""
    fam = registry.reference(cfg["family"])
    diffs = []
    for key, want in fam.expect(cfg, fam.sizes(cfg)).items():
        node = pcfg
        for part in key.split("."):
            node = getattr(node, part)
        if isinstance(want, Defaulted):
            node = want.default(pcfg) if node is None else node
            want = want.value
        if node != want:
            diffs.append(f"{key}: program {node!r}, configuration {want!r}")
    if diffs:
        raise ValueError("the program's architecture differs from the configuration: "
                         + "; ".join(diffs))


def build(cfg: Dict[str, Any], weights, device, dtype, **runner_kwargs):
    """The port's runner for the configuration, on the benchmark's weights."""
    from mimic_tpu_torch.models.factory import build_model, check_params

    runner = build_model(cfg["program_model"], params=weights, device=device, dtype=dtype,
                         **runner_kwargs)
    check_architecture(runner.cfg, cfg)
    check_params(weights, runner.cfg)
    return runner
