"""``image_encode_ms_per_image.eval`` (ms): device time of the program's
``lvlm.encode_images`` spans (the vision tower and the connector in each
call's prefill) per image row the tower ran on (``images_encoded``), in the
window's generate calls.  Layer: vision tower and connector.  Moves
``eval_questions_per_s``."""

from benchmark.lib.program_spans import device_ms_per_count


def read(rec):
    return device_ms_per_count(rec, "calls", "lvlm.encode_images", "images_encoded")
