"""``idle_in_processor_pct.eval`` (%): the share of the traced window when
the device runs no operation and the host is in one of the program's
``processor.*`` spans.  Layer: runner and processor.  Moves
``eval_questions_per_s``."""

from benchmark.lib.program_spans import idle_in_pct


def read(rec):
    return idle_in_pct(rec, "calls", "processor.")
