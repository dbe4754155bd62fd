"""Build the JAX package's native library once, before any test process
needs it.

``wav2letter_pytorch_tpu/decoding/levenshtein.py::_load_native`` runs
``make -C native`` in every process that finds ``native/libw2l_native.so``
missing (the library is not in the repository). Under pytest-xdist several
workers can do that at once: they link the same file together, and a
worker that opens it half-written gets an ``OSError`` and keeps "no native
library" for the rest of its life, so every test of the native ARPA scorer
in that worker fails. Building here, in the xdist controller (or the only
process of a run without xdist) before the workers start, leaves them a
finished library. A failed build is ignored: the tests then behave as
without this hook.
"""

import os
import subprocess


def pytest_configure(config):
    if hasattr(config, 'workerinput'):  # an xdist worker: the controller built
        return
    native = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'native')
    try:
        subprocess.run(['make', '-C', native], stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=600, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
