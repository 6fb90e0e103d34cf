"""The port's lexsort kernel route (`ops/lexsort_kernel.py`,
`csrc/lexsort.cu`) on the CPU, exact equality throughout (permutations:
the tolerance is equality):

- the plain sibling sort (`list_rank.sibling_sort`) and
  `sibling_sort_auto` against `jnp.lexsort` as the JAX package calls it
  at `automerge_tpu/ops/list_rank.py:73`, over every named trap
  (`tests/torch_lexsort_cases.py`);
- the plain register order (`parallel/mesh.py::register_order`) and
  `register_sort_auto` against the JAX step's per-doc
  `jnp.lexsort((time, group))` offset by d * T;
- `lexsort_model`, the kernel's algorithm in numpy (its plan, passes,
  skipped passes, block and warp segments), against both, on route (b)'s
  H100 grid and on a small grid that splits the cases into several
  blocks;
- the wrappers' checks, and that the card paths reach the kernel.

The kernel itself runs in `chip_smoke.py` on the card."""

import ast
import glob
import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu_torch.ops import _build, lexsort_kernel, list_rank
from automerge_tpu_torch.ops import linearize_kernel
from automerge_tpu_torch.ops.lexsort_kernel import (register_sort_auto,
                                                    register_sort_cuda,
                                                    sibling_sort_auto,
                                                    sibling_sort_cuda)
from automerge_tpu_torch.parallel import mesh
from torch_lexsort_cases import (ONE_CTA_MAX, groups_in_range,
                                 lexsort_model, register_cases,
                                 register_reference, sibling_cases,
                                 sibling_reference)
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIBLING = sibling_cases(np.random.RandomState(18))
REGISTER = register_cases(np.random.RandomState(19))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_sibling(obj, parent, ctr, actor, valid):
    """The JAX package's sibling sort, as at list_rank.py:71-73."""
    obj, parent, ctr, actor = (jnp.asarray(x, jnp.int32)
                               for x in (obj, parent, ctr, actor))
    skey_obj = jnp.where(jnp.asarray(valid), obj, jnp.int32(2 ** 30))
    return np.asarray(jnp.lexsort((-actor, -ctr, parent, skey_obj)))


def jax_register(rg, rt):
    """The JAX step's per-doc register sort (registers.py:267, vmapped
    over docs), offset by each doc's first row."""
    D, T = rg.shape
    if D * T == 0:
        return np.zeros(0, np.int64)
    per_doc = np.stack([np.asarray(jnp.lexsort((jnp.asarray(rt[d]),
                                                jnp.asarray(rg[d]))))
                        for d in range(D)])
    return (per_doc + np.arange(D)[:, None] * T).reshape(-1)


@pytest.mark.parametrize('label,case', SIBLING, ids=[c[0] for c in SIBLING])
def test_sibling_sort_matches_jax(label, case):
    want = jax_sibling(*case)
    assert (sibling_reference(*case) == want).all()
    plain = list_rank.sibling_sort(*[t(x) for x in case])
    auto = sibling_sort_auto(*[t(x) for x in case])
    assert plain.dtype == auto.dtype == torch.int32
    assert plain.shape == auto.shape == (case[0].shape[0],)
    assert (plain.numpy() == want).all()
    assert (auto.numpy() == want).all()


@pytest.mark.parametrize('grid', [132, 5])
@pytest.mark.parametrize('label,case', SIBLING, ids=[c[0] for c in SIBLING])
def test_sibling_model_matches_jax(label, case, grid):
    got, info = lexsort_model('sibling', case, grid_blocks=grid)
    assert (got == jax_sibling(*case)).all()
    L = case[0].shape[0]
    assert info['route'] == ('a' if L <= ONE_CTA_MAX else 'b')
    assert info['passes'] <= 16


@pytest.mark.parametrize('label,case', REGISTER,
                         ids=[c[0] for c in REGISTER])
def test_register_order_matches_jax(label, case):
    rg, rt, n_groups = case
    plain = mesh.register_order(t(rg), t(rt), n_groups)
    auto = register_sort_auto(t(rg), t(rt), n_groups)
    assert plain.dtype == auto.dtype == torch.int32
    assert plain.shape == auto.shape == (rg.size,)
    assert (auto.numpy() == plain.numpy()).all()
    if groups_in_range(rg, n_groups):
        want = jax_register(rg, rt)
        assert (register_reference(rg, rt) == want).all()
        assert (plain.numpy() == want).all()


@pytest.mark.parametrize('grid', [132, 3])
@pytest.mark.parametrize('label,case', REGISTER,
                         ids=[c[0] for c in REGISTER])
def test_register_model_matches_plain_and_jax(label, case, grid):
    rg, rt, n_groups = case
    got, info = lexsort_model('register', case, grid_blocks=grid)
    plain = mesh.register_order(t(rg), t(rt), n_groups).numpy()
    assert (got == plain).all()
    if groups_in_range(rg, n_groups):
        assert (got == jax_register(rg, rt)).all()
    assert info['passes'] <= 12


def test_model_pays_only_for_the_bits_that_vary():
    """A text typed at its head: one object, every parent -1, one actor;
    the counters take 13 bits at 5,000 rows, the object and the parent a
    bit each (the padding's sentinel and its parent 0), the actor none;
    and a digit that is the same in every row is a skipped pass."""
    case = dict(SIBLING)['typed at its head, 5,000 rows']
    got, info = lexsort_model('sibling', case)
    assert (got == jax_sibling(*case)).all()
    assert info['widths'] == [1, 1, 13, 0] and info['passes'] == 2
    # counters 0 and 65,536 apart: bits 0-15 of the composite never vary
    ctr = np.array([0, 65536, 0, 65536, 65536], np.int32)
    case = [np.zeros(5, np.int32), np.full(5, -1, np.int32), ctr,
            np.zeros(5, np.int32), np.ones(5, bool)]
    got, info = lexsort_model('sibling', case)
    assert (got == jax_sibling(*case)).all()
    assert info['passes'] == 3 and info['skipped'] == [0, 1]
    assert got.tolist() == [1, 3, 4, 0, 2]


def test_model_splits_route_b_into_blocks_and_warps():
    """Route (b) on the H100 grid at 20,000 rows: 20 blocks of 1,024
    positions; on a grid of 5, blocks of 4,096 and warps of 128."""
    case = dict(SIBLING)['typed at its head, 20,000 rows (route b)']
    assert lexsort_model('sibling', case)[1]['blocks'] == 20
    assert lexsort_model('sibling', case, grid_blocks=5)[1]['blocks'] == 5


def _sibling_cols():
    case = dict(SIBLING)['forest L=33']
    return [t(x) for x in case]


def test_cuda_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        sibling_sort_cuda(*_sibling_cols())
    rg, rt, n = dict(REGISTER)['all-padding docs']
    with pytest.raises(ValueError, match='CUDA'):
        register_sort_cuda(t(rg), t(rt), n)


def test_auto_wrappers_raise_on_a_meta_tensor():
    cols = [torch.zeros(8, dtype=torch.int32, device='meta')
            for _ in range(4)] + [torch.zeros(8, dtype=torch.bool,
                                              device='meta')]
    with pytest.raises(ValueError, match='meta'):
        sibling_sort_auto(*cols)
    rg = torch.zeros((2, 4), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='meta'):
        register_sort_auto(rg, rg, 3)


@pytest.mark.parametrize('fn', [sibling_sort_auto, sibling_sort_cuda])
@pytest.mark.parametrize('which,bad', [
    (0, lambda x: x.to(torch.int64)),
    (1, lambda x: x.to(torch.float32)),
    (2, lambda x: x[:-1]),
    (3, lambda x: x.to(torch.int16)),
    (4, lambda x: x.to(torch.int32)),
    (4, lambda x: x[1:]),
    (0, lambda x: x[None]),
])
def test_sibling_wrappers_reject_bad_dtypes_and_shapes(fn, which, bad):
    cols = _sibling_cols()
    cols[which] = bad(cols[which])
    with pytest.raises(ValueError):
        fn(*cols)


@pytest.mark.parametrize('fn', [register_sort_auto, register_sort_cuda])
@pytest.mark.parametrize('change', [
    lambda rg, rt, n: (rg.to(torch.int64), rt, n),
    lambda rg, rt, n: (rg, rt.to(torch.float32), n),
    lambda rg, rt, n: (rg.reshape(-1), rt.reshape(-1), n),
    lambda rg, rt, n: (rg, rt[:, :-1], n),
    lambda rg, rt, n: (rg, rt, -1),
    lambda rg, rt, n: (rg, rt, 2.5),
    lambda rg, rt, n: (rg, rt, True),
])
def test_register_wrappers_reject_bad_dtypes_shapes_and_bounds(fn, change):
    rg, rt, n = dict(REGISTER)['all-padding docs']
    with pytest.raises(ValueError):
        fn(*change(t(rg), t(rt), n))


def test_kernel_is_built_from_its_source():
    entry = _build.KERNELS['lexsort']
    assert set(entry) == {'amtpu_torch_sibling_sort',
                          'amtpu_torch_register_sort',
                          'amtpu_torch_lexsort_scratch'}
    with open(os.path.join(_build.CSRC, 'lexsort.cu')) as f:
        src = f.read()
    for name in entry:
        assert 'extern "C" ' in src and name + '(' in src
    assert 'cudaLaunchCooperativeKernel' in src
    limit = re.search(r'kOneCtaMax = (\d+);', src)
    assert int(limit.group(1)) == lexsort_kernel.ONE_CTA_MAX == ONE_CTA_MAX


def test_no_library_sort_in_the_kernels():
    for path in glob.glob(os.path.join(_build.CSRC, '*')):
        with open(path) as f:
            src = f.read()
        assert 'DeviceRadixSort' not in src and 'thrust' not in src, path


#: the two plain functions that may call torch's sort
PLAIN_SORTS = {('automerge_tpu_torch/ops/list_rank.py', 'sibling_sort'),
               ('automerge_tpu_torch/parallel/mesh.py', 'register_order')}


def torch_sort_calls(path):
    """(function, line) of every `torch.sort` / `torch.argsort` /
    `torch.msort` call in `path`, by the innermost enclosing function."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    hits = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute) and f.attr in (
                        'sort', 'argsort', 'msort') and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == 'torch':
                    hits.append((name, child.lineno))
            visit(child, name)
    visit(tree, None)
    return hits


def test_torch_sorts_only_in_the_plain_versions():
    """On the card every sort is the kernel's: torch's sort appears only
    inside `list_rank.sibling_sort` and `mesh.register_order`."""
    files = glob.glob(os.path.join(ROOT, 'automerge_tpu_torch', '**',
                                   '*.py'), recursive=True)
    found = set()
    for path in files:
        rel = os.path.relpath(path, ROOT)
        for fn, line in torch_sort_calls(path):
            assert (rel, fn) in PLAIN_SORTS, (rel, fn, line)
            found.add((rel, fn))
    assert found == PLAIN_SORTS


def test_the_sort_scan_finds_a_call(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('import torch\n\ndef f(x):\n'
                     '    return torch.sort(x).indices\n\n'
                     'y = torch.argsort(z)\nxs.sort(key=len)\n')
    assert torch_sort_calls(str(probe)) == [('f', 4), (None, 6)]


def called_names(fn):
    """The dotted names of every call in fn's body."""
    def dotted(node):
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            base = dotted(node.value)
            return None if base is None else base + '.' + node.attr
        return None
    tree = ast.parse(inspect.getsource(fn).lstrip())
    return {dotted(n.func) for n in ast.walk(tree)
            if isinstance(n, ast.Call)} - {None}


def test_card_paths_call_the_kernel():
    """`linearize_cuda` sorts with `sibling_sort_cuda` where it is given
    no sort (through the module, where `chip_smoke.py` captures it), and
    calls no plain sort."""
    names = called_names(linearize_kernel.linearize_cuda)
    assert 'lexsort_kernel.sibling_sort_cuda' in names
    assert not {n for n in names if n.split('.')[-1] == 'sibling_sort'}


def test_the_step_sorts_its_registers_through_the_switch(monkeypatch):
    """`single_step` on the CPU orders its register rows with
    `register_sort_auto` once, and its outputs stay the plain ones."""
    from automerge_tpu_torch.parallel import mesh_encode
    calls = []
    real = mesh.register_sort_auto

    def spy(rg, rt, n_groups):
        calls.append((tuple(rg.shape), n_groups))
        return real(rg, rt, n_groups)
    batch, _ = mesh_encode.encode_batch(mesh_encode.scaling_workload(6))
    want = mesh.single_step(batch, 6, device='cpu')
    monkeypatch.setattr(mesh, 'register_sort_auto', spy)
    got = mesh.single_step(batch, 6, device='cpu')
    assert calls == [(tuple(batch['rg'].shape), mesh.n_groups_of(batch))]
    for k in want:
        assert torch.equal(got[k], want[k]), k
