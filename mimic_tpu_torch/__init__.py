"""mimic_tpu_torch — the MimIC train, eval and serving paths in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``mimic_tpu`` (JAX/Pallas), which stays the reference.  Module paths
and function names mirror the JAX package, so
``mimic_tpu_torch/models/decoder.py::decoder_forward`` is the counterpart of
``mimic_tpu/models/decoder.py::decoder_forward``.  Parameters are dicts of
stacked ``[L, ...]`` tensors with the same tree as the JAX pytree
(``bridge.py`` maps one to the other).

This package imports ``torch`` and never ``jax``, and nothing of ``mimic_tpu``:
the modules of the JAX package that import no JAX (configs, processor,
tokenizer, templates, dataset adapters, metrics, the native C++ helpers, the
training collator) are kept here as copies under the same relative names
(``tests/test_torch_copies.py`` holds each copy to its source).
"""

__version__ = "0.1.0"
