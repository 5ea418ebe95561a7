"""``image_encode_ms_per_image.train`` (ms): device time of the program's
``lvlm.encode_images`` spans (``models/lvlm.py``: the vision tower and the
connector, in both passes) per image row the tower ran on (its
``images_encoded`` counter), in the window's train steps.  Layer: vision tower
and connector.  Moves ``train_samples_per_s``."""

from benchmark.lib.program_spans import device_ms_per_count


def read(rec):
    return device_ms_per_count(rec, "steps", "lvlm.encode_images", "images_encoded")
