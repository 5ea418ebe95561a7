"""Repository-level test set-up: build the JAX package's native library once.

``mimic_tpu/native`` compiles its C++ sources on first use into the user cache
through one shared temporary file name.  Under pytest-xdist every worker would
otherwise start that build at once on a cold cache; the workers that lose the
race find no library and skip the native tests.  This hook runs the build once
in the process that starts the workers (or in the only process, without
xdist), before any test is collected, so every worker loads the finished
library.  It imports only ``mimic_tpu.native``, which imports no JAX, so the
JAX platform settings of ``tests/conftest.py`` still come first.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built the library already
    from mimic_tpu.native import native_available

    native_available()
