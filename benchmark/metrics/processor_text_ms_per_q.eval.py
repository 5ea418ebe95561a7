"""``processor_text_ms_per_q.eval`` (ms): host time of the runner's two
processor calls (the program's ``processor.probe`` and ``processor.encode``
spans in ``models/runner.py::generate``: the width probe, tokenising and
padding), less their image work (``processor.images``), per question
answered.  Layer: runner and processor.  Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import host_ms_per_question


def read(rec):
    return host_ms_per_question(rec, ("processor.probe", "processor.encode"),
                                minus=("processor.images",))
