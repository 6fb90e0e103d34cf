"""automerge_tpu_torch stands alone: no module of the package, no line
of chip_smoke.py and nothing of the test helpers it imports pulls in JAX
or the JAX package, none of them names a JAX-package module in a string
(a spawned server's `-m` module), and the pool's default device is CUDA,
with no silent fallback to the CPU."""

import ast
import glob
import os
import re

import pytest
import torch

from automerge_tpu_torch.native import NativeDocPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, 'automerge_tpu_torch', '**',
                                      '*.py'), recursive=True)) + \
    [os.path.join(ROOT, 'chip_smoke.py'),
     os.path.join(ROOT, 'tests', 'torch_member_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_serving_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_step_cases.py')]


def _forbidden(name):
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'automerge_tpu')


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                    '__import__', 'import_module') and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize('path', FILES,
                         ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_no_jax_or_automerge_tpu_imports(path):
    assert os.path.exists(path)
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, '%s imports %s' % (os.path.relpath(path, ROOT), bad)


#: a JAX-package module named in a string (a spawned `-m` module, a
#: lazy import by name): `automerge_tpu.` with no `_torch` between
_JAX_MODULE_STRING = re.compile(r'\bautomerge_tpu\.')


@pytest.mark.parametrize('path', FILES,
                         ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_no_jax_package_module_strings(path):
    """Module strings reach no import walk (`python -m ...` in a spawn
    argv, the supervisor's and client's server module), so the text of
    every file is scanned too."""
    with open(path) as f:
        hits = [(i + 1, line.strip()) for i, line in enumerate(f)
                if _JAX_MODULE_STRING.search(line)]
    assert not hits, '%s names JAX-package modules: %s' % (
        os.path.relpath(path, ROOT), hits)


def test_string_scan_catches_a_jax_module_string():
    assert _JAX_MODULE_STRING.search(
        "[sys.executable, '-m', 'automerge_tpu.sidecar.server']")
    assert not _JAX_MODULE_STRING.search(
        "[sys.executable, '-m', 'automerge_tpu_torch.sidecar.server']")
    assert not _JAX_MODULE_STRING.search('automerge_tpu/ops/x.py:48')


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('import numpy\nfrom automerge_tpu.ops import x\n'
                     'import jax.numpy as jnp\n')
    assert [n for n in _imports(str(probe)) if _forbidden(n)] == \
        ['automerge_tpu.ops', 'jax.numpy']


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default pool is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        NativeDocPool()


def test_unknown_device_rejected():
    with pytest.raises(ValueError):
        NativeDocPool(device='meta')
