"""Shift parameters and math (counterparts of ``mimic_tpu/shift``)."""
