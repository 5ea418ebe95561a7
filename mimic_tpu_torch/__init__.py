"""mimic_tpu_torch — the MimIC serving path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``mimic_tpu`` (JAX/Pallas), which stays the reference.  Module paths
and function names mirror the JAX package, so
``mimic_tpu_torch/models/decoder.py::decoder_forward`` is the counterpart of
``mimic_tpu/models/decoder.py::decoder_forward``.  Parameters are dicts of
stacked ``[L, ...]`` tensors with the same tree as the JAX pytree
(``bridge.py`` maps one to the other).

This package imports ``torch`` and never ``jax``.  From ``mimic_tpu`` it reuses
only modules that import no JAX (``models.config``, ``models.processor``,
``models.tokenizer``, ``data.templates`` and ``config``), all through
``shared.py``.
"""

__version__ = "0.1.0"
