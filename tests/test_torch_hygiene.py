"""The port stands alone: it imports neither JAX nor the JAX package, and
importing it builds or loads no CUDA library and no host library; the host
library it loads is its own (csrc/host/), never native/libw2l_native.so."""

import ast
import os
import pkgutil
import subprocess
import sys

import torch

import wav2letter_pytorch_tpu_torch
from wav2letter_pytorch_tpu_torch import _build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(wav2letter_pytorch_tpu_torch.__file__)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'wav2letter_pytorch_tpu')


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix='wav2letter_pytorch_tpu_torch.'))


def _port_sources():
    tools = os.path.join(REPO, 'tools')
    files = [os.path.join(REPO, 'chip_smoke.py')] + [
        os.path.join(tools, n) for n in os.listdir(tools)
        if n.endswith('.py')]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def test_every_module_imports_with_the_jax_package_blocked():
    """A None entry in sys.modules makes any import of that name fail."""
    mods = _port_modules() + ['chip_smoke']
    assert {'wav2letter_pytorch_tpu_torch.evaluate',
            'wav2letter_pytorch_tpu_torch.train'} <= set(mods)
    code = ('import sys\n'
            f'for name in {FORBIDDEN!r}:\n'
            '    sys.modules[name] = None\n'
            'import importlib\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'loaded = [m for m in sys.modules if m.split(".")[0] in '
            f'{FORBIDDEN!r} and sys.modules[m] is not None]\n'
            'assert not loaded, loaded\n'
            'from wav2letter_pytorch_tpu_torch import _build\n'
            'assert not _build._LIBS\n'
            'assert not _build._HOST\n'
            'maps = open("/proc/self/maps").read()\n'
            'assert "libw2l" not in maps\n'
            'from wav2letter_pytorch_tpu_torch.decoding import levenshtein\n'
            'assert levenshtein.distance("kitten", "sitting") == 3\n'
            'maps = open("/proc/self/maps").read()\n'
            'assert "libw2l_host-" in maps and "libw2l_native" not in maps\n'
            'print("ok")\n')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_no_source_names_jax_or_the_jax_package_in_an_import():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split('.')[0] in FORBIDDEN]
    assert not bad


def test_no_source_names_the_jax_native_library():
    """The port builds and loads its own host library (csrc/host/); it
    never runs ``make -C native`` nor loads ``libw2l_native.so``."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        bad += [(path, w) for w in ('libw2l_native', '_load_native', 'make -C')
                if w in text]
    assert not bad


def test_kernel_sources_and_build_hash():
    assert _build.kernel_sources() == ['ctc_alpha', 'ctc_beta', 'depthwise',
                                      'sep_conv', 'stft_mel']
    a = _build._library_path('stft_mel')
    b = _build._library_path('ctc_alpha')
    assert a != b and a.startswith(_build.BUILD_DIR)
    assert os.path.basename(a).startswith('stft_mel-')
    # nothing was built or loaded by importing or by the CPU tests
    assert _build._LIBS == {}
    host = _build.host_library_path()
    assert host.startswith(_build.HOST_BUILD_DIR)
    assert os.path.basename(host).startswith('libw2l_host-')
    assert sorted(os.path.basename(p) for p in _build._host_sources()) == [
        'arpa_lm.cpp', 'beam_search.cpp', 'greedy.cpp', 'levenshtein.cpp']
