"""Build and load the hand-written CUDA kernels under ``csrc/`` and the
host library under ``csrc/host/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

Libraries are built at first use into ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds. Several sources are built in parallel. A failed build raises
with nvcc's output. Nothing here runs when a module is imported: the CPU
path never builds or loads a CUDA library.

The host library (edit distance, greedy collapse, the ARPA scorer, the
prefix beam search and the FLAC codec: ``csrc/host/*.cpp``) is one shared
library built by ``g++ -O3 -fPIC -std=c++17 -shared`` at first use into
``build/host/``,
keyed the same way; a failed build raises with g++'s output.
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

HOST_SRC_DIR = os.path.join(CSRC_DIR, 'host')
HOST_BUILD_DIR = os.path.join(os.path.dirname(BUILD_DIR), 'host')
GXX_FLAGS = ['-O3', '-fPIC', '-std=c++17', '-shared']

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_HOST: list[ctypes.CDLL] = []  # the loaded host library, once loaded


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


# ---------------------------------------------------------------- host


def _host_sources() -> list[str]:
    return sorted(glob.glob(os.path.join(HOST_SRC_DIR, '*.cpp')))


def host_library_path() -> str:
    h = hashlib.sha256()
    for path in _host_sources():
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(' '.join(GXX_FLAGS).encode())
    return os.path.join(HOST_BUILD_DIR, f'libw2l_host-{h.hexdigest()[:16]}.so')


def build_host() -> str:
    """Compile ``csrc/host/*.cpp`` into one shared library unless it is
    already built; returns its path. Raises with g++'s output if the build
    fails. Concurrent builders each write their own temporary file and
    rename it into place."""
    path = host_library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found on PATH: the host library '
                           f'({HOST_SRC_DIR}) cannot be built')
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [cxx, *GXX_FLAGS, '-o', tmp, *_host_sources()]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'g++ failed:\n{" ".join(cmd)}\n(exit '
                           f'{proc.returncode})\n{proc.stdout}')
    os.replace(tmp, path)
    return path


def _declare_host(lib: ctypes.CDLL) -> None:
    c = ctypes
    u32p, i32p = c.POINTER(c.c_uint32), c.POINTER(c.c_int32)
    i64p, f32p = c.POINTER(c.c_int64), c.POINTER(c.c_float)
    for name, restype, argtypes in (
            ('w2l_levenshtein_u32', c.c_int64,
             [u32p, c.c_int64, u32p, c.c_int64]),
            ('w2l_levenshtein_u32_batch', None,
             [u32p, i64p, u32p, i64p, c.c_int64, i64p]),
            ('w2l_greedy_collapse', c.c_int64,
             [i32p, c.c_int64, c.c_int64, i32p, i32p]),
            ('w2l_arpa_load', c.c_void_p, [c.c_char_p]),
            ('w2l_arpa_score', c.c_double,
             [c.c_void_p, c.c_char_p, c.c_int, c.c_int]),
            ('w2l_arpa_order', c.c_int, [c.c_void_p]),
            ('w2l_arpa_free', None, [c.c_void_p]),
            ('w2l_prefix_beam_search', c.c_int64,
             [f32p, c.c_int64, c.c_int64, u32p, c.c_int64, c.c_void_p,
              c.c_int64, c.c_double, c.c_double, c.c_double, c.c_uint32,
              u32p, i64p, c.c_int64, c.c_double, u32p, c.c_int64,
              c.POINTER(c.c_double)]),
            ('w2l_flac_parse_info', c.c_int, [c.c_char_p, c.c_int64, i64p]),
            ('w2l_flac_decode_all', c.c_int64,
             [c.c_char_p, c.c_int64, i32p, c.c_int64, c.c_int]),
            ('w2l_flac_encode_fixed', c.c_int64,
             [i32p, c.c_int64, c.c_int, c.c_int64, c.c_int, c.c_int64,
              c.c_char_p, c.POINTER(c.c_uint8), c.c_int64])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_host() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    with _LOCK:
        if not _HOST:
            lib = ctypes.CDLL(build_host())
            _declare_host(lib)
            _HOST.append(lib)
        return _HOST[0]
