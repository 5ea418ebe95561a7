"""``processor_pixels_ms_per_q.eval`` (ms): host self time of the program's
``processor.images`` spans (array conversion, rescale, normalise, padding and
stacking of the images; the resizes left out) per question answered.  Layer:
runner and processor.  Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import host_ms_per_question


def read(rec):
    return host_ms_per_question(rec, ("processor.images",), self_time=True)
