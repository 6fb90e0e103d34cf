"""automerge_tpu_torch stands alone: no module of the package, no line
of chip_smoke.py and nothing of the test helpers it imports pulls in JAX
or the JAX package, none of them names a JAX-package module in a string
(a spawned server's `-m` module), and the pool's default device is CUDA,
with no silent fallback to the CPU.  Importing the package's API loads
neither torch nor a kernel.

The port's tests drive JAX pools beside port pools in shared worker
processes, and the JAX library latches its resident-mode knobs at its
first batch in a process.  So no port test may set one of those knobs
(`automerge_tpu.native._RESIDENT_LATCH_KEYS`) to anything but its
default, or a later JAX-package test in the same worker runs with it;
`tests/test_torch_resident.py` sets them in a subprocess of its own."""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from automerge_tpu_torch.native import NativeDocPool
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, 'automerge_tpu_torch', '**',
                                      '*.py'), recursive=True)) + \
    [os.path.join(ROOT, 'chip_smoke.py'),
     os.path.join(ROOT, 'tests', 'torch_member_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_serving_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_frontend_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_step_cases.py'),
     os.path.join(ROOT, 'tests', 'torch_linearize_cases.py')]


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


#: JAX-package modules whose port lives under another path
COUNTERPARTS = {
    'native/batch_resident.py': 'native/clock_cache.py',
    'utils/common.py': 'utils/__init__.py',
    'utils/wire.py': 'utils/__init__.py',
}
#: JAX-package modules with no port module, each with its reason
JAX_ONLY = {
    'ops/pallas_common.py': 'the Pallas on/off latch; the port\'s kernels '
                            'are CUDA (ops/_build.py builds them)',
    'ops/pallas_registers.py': 'K1 in Pallas; ported as csrc/registers.cu '
                               '(ops/registers_kernel.py)',
    'ops/pallas_dominance.py': 'K2 in Pallas; ported as csrc/dominance.cu '
                               '(ops/dominance_kernel.py)',
    'utils/jaxenv.py': 'JAX platform and CPU-device setup',
}
JAX_MODULES = sorted(
    os.path.relpath(p, os.path.join(ROOT, 'automerge_tpu'))
    for p in glob.glob(os.path.join(ROOT, 'automerge_tpu', '**', '*.py'),
                       recursive=True))


@pytest.mark.parametrize('module', JAX_MODULES)
def test_every_jax_module_has_a_port_counterpart(module):
    """The port does all that the JAX package does: each JAX module has
    its port module (same path unless COUNTERPARTS names another) or a
    reasoned JAX_ONLY entry."""
    if module in JAX_ONLY:
        assert module not in COUNTERPARTS
        return
    port = COUNTERPARTS.get(module, module)
    assert os.path.exists(os.path.join(ROOT, 'automerge_tpu_torch', port)), \
        '%s has no port module %s' % (module, port)


def test_counterpart_map_names_existing_jax_modules():
    assert set(COUNTERPARTS) | set(JAX_ONLY) <= set(JAX_MODULES)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default pool is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        NativeDocPool()


def test_unknown_device_rejected():
    with pytest.raises(ValueError):
        NativeDocPool(device='meta')


def test_api_import_loads_no_torch():
    """`import automerge_tpu_torch as am` gives the user's surface and
    leaves torch, CUDA and the kernels to the pool modules."""
    code = ('import sys; import automerge_tpu_torch as am; '
            'd = am.change(am.init("a"), lambda x: x.update({"k": 1})); '
            'assert am.load(am.save(d))["k"] == 1; '
            'print(sorted(m for m in ("torch", "numpy", "jax") '
            'if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == '[]'


#: the default of each latched knob, as a test may write it: None where
#: any value set differs from leaving the knob unset
LATCH_DEFAULTS = {'AMTPU_RESIDENT': None, 'AMTPU_RESIDENT_MIN': '16384',
                  'AMTPU_RESIDENT_CLK': '1',
                  'AMTPU_RESCLK_MAX_ACTORS': '512',
                  'AMTPU_RESCLK_MAX_ROWS': '1048576',
                  'AMTPU_TRIVIAL_HOST': '1', 'AMTPU_MESH': None}
#: the first two run their latched scenarios in subprocesses of their
#: own; this file holds the scan's table and probe, and sets nothing
LATCH_EXEMPT = ('test_torch_resident.py', 'test_torch_mesh_fence.py',
                'test_torch_isolation.py')
PORT_TESTS = sorted(glob.glob(os.path.join(ROOT, 'tests',
                                           'test_torch_*.py')))


def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def latch_settings(src):
    """(line, key, value) of every latched knob the source sets:
    `setenv(key, value)`, a `(key, value)` pair, a `{key: value}` entry,
    a `dict(..., KEY=value)` keyword or `os.environ[key] = value`."""
    keys = set(LATCH_DEFAULTS)
    out = []
    for node in ast.walk(ast.parse(src)):
        pairs = []
        if isinstance(node, ast.Call):
            if getattr(node.func, 'attr', None) == 'setenv' and \
                    len(node.args) >= 2:
                pairs.append((node.args[0], node.args[1]))
            pairs += [(ast.Constant(kw.arg), kw.value)
                      for kw in node.keywords if kw.arg in keys]
        elif isinstance(node, ast.Tuple) and len(node.elts) == 2:
            pairs.append(tuple(node.elts))
        elif isinstance(node, ast.Dict):
            pairs += [(k, v) for k, v in zip(node.keys, node.values) if k]
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    pairs.append((t.slice, node.value))
        for k, v in pairs:
            if _const(k) in keys:
                out.append((node.lineno, _const(k), _const(v)))
    return out


def _violations(src):
    return sorted((line, k, v) for line, k, v in latch_settings(src)
                  if LATCH_DEFAULTS[k] is None or str(v) != LATCH_DEFAULTS[k])


def test_latch_keys_are_the_jax_packages():
    from automerge_tpu.native import _RESIDENT_LATCH_KEYS
    assert set(LATCH_DEFAULTS) == set(_RESIDENT_LATCH_KEYS)


@pytest.mark.parametrize('path', PORT_TESTS,
                         ids=[os.path.basename(p) for p in PORT_TESTS])
def test_port_tests_leave_latched_knobs_at_their_defaults(path):
    if os.path.basename(path) in LATCH_EXEMPT:
        return
    with open(path) as f:
        bad = _violations(f.read())
    assert not bad, '%s sets latched knobs: %s' % (
        os.path.relpath(path, ROOT), bad)


def test_latch_scan_catches_a_probe_fixture():
    probe = (
        "@pytest.fixture(autouse=True)\n"
        "def env(monkeypatch):\n"
        "    for k, v in (('AMTPU_HOST_FULL', '0'),\n"
        "                 ('AMTPU_RESIDENT', '0'),\n"
        "                 ('AMTPU_RESIDENT_CLK', '1')):\n"
        "        monkeypatch.setenv(k, v)\n"
        "    monkeypatch.setenv('AMTPU_RESIDENT_MIN', '16')\n"
        "    os.environ['AMTPU_MESH'] = '2'\n"
        "    return dict(os.environ, AMTPU_TRIVIAL_HOST='0')\n")
    assert _violations(probe) == [
        (4, 'AMTPU_RESIDENT', '0'), (7, 'AMTPU_RESIDENT_MIN', '16'),
        (8, 'AMTPU_MESH', '2'), (9, 'AMTPU_TRIVIAL_HOST', '0')]
    with open(os.path.join(ROOT, 'tests', LATCH_EXEMPT[0])) as f:
        assert _violations(f.read())
