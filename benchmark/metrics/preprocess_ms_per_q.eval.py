"""``preprocess_ms_per_q.eval`` (ms): host time inside the runner's
processor (``models/processor.py``: the width probe, tokenising, resizing
and normalising the images) per question answered, from the benchmark's
span around the runner's ``processor`` attribute in the traced run.  Layer:
runner and processor (``models/runner.py``, ``models/processor.py``).
Moves ``eval_questions_per_s``."""

from benchmark.lib.readers import has


def read(rec):
    if not has(rec, "calls") or "processor" not in rec.span_seconds:
        return None
    return 1000.0 * rec.span_seconds["processor"] / rec.work["units"]
