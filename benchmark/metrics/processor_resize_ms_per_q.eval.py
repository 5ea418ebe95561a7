"""``processor_resize_ms_per_q.eval`` (ms): host time of the program's
``processor.resize`` spans (the PIL-exact resize of each image, the native
C++ through ctypes) per question answered.  Layer: runner and processor.
Moves ``eval_questions_per_s``."""

from benchmark.lib.program_spans import host_ms_per_question


def read(rec):
    return host_ms_per_question(rec, ("processor.resize",))
