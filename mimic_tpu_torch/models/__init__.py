"""Model modules of the port (counterparts of ``mimic_tpu/models``)."""
