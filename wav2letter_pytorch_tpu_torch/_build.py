"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

Libraries are built at first use into ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds. Several sources are built in parallel. A failed build raises
with nvcc's output. Nothing here runs when a module is imported: the CPU
path never builds or loads a CUDA library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'build', 'kernels')
# Shared memory one block may use on an H100 (227 KB); wrappers check a
# launch's need against it and raise before launching.
SMEM_LIMIT_BYTES = 232448
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    path = shutil.which('nvcc')
    if path:
        return path
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found (looked on PATH, in $CUDA_HOME/bin '
                       'and /usr/local/cuda/bin): the CUDA kernels cannot '
                       'be built')


def _library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f'{name}.cu')
    if not os.path.exists(src):
        raise FileNotFoundError(f'no kernel source {src}')
    h = hashlib.sha256()
    # Headers are shared, so every .cuh feeds every library's hash.
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together. Returns ``{name: .so
    path}``; raises with nvcc's output if any build fails. nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``<library>.log``."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = f'{p}.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, f'{n}.cu')]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failures = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f'{" ".join(cmd)}\n(exit {proc.returncode})\n'
                            f'{out}')
            continue
        with open(paths[n] + '.log', 'w') as f:
            f.write(out)
        os.replace(tmp, paths[n])  # atomic: readers never see a partial .so
    if failures:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')


def kernel_sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, '*.cu')))
