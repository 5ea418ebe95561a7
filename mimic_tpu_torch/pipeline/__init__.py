"""Pipeline entry points of the port (counterparts of ``mimic_tpu/pipeline``)."""
