"""``prefill_ms_per_call.eval`` (ms): device self time of the program's
``generate.prefill`` spans (``models/generate.py::_prefill``: the prompt
through the decoder into the cache, its image encoding left out) per
generate call.  Layer: generation.  Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "calls", "generate.prefill", self_time=True)
