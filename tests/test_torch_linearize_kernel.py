"""The port's linearize kernel route (`ops/linearize_kernel.py`,
`csrc/linearize.cu`) on the CPU: the same numpy inputs go through the
JAX function `automerge_tpu/ops/list_rank.py::linearize`, the port's
plain version and `linearize_auto`, and all three must agree exactly
(integer ranks: the tolerance is equality), with the host's sibling sort
and with the sort on the device.  The round counts are pinned: n_iters
of 0, 1, 2 and too few for a chain give the plain version's partial
ranks, which the kernel must reproduce.  `linearize_model`
(`tests/torch_linearize_cases.py`), the kernel's algorithm with its early
stop, is held to the plain version on every case and at the edges of
the kernel's two routes.  The CUDA wrapper's checks run here; the
kernel itself runs in `chip_smoke.py` on the card."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from automerge_tpu.ops import list_rank as jax_list_rank
from automerge_tpu_torch.ops import _build, list_rank
from automerge_tpu_torch.ops.linearize_kernel import (linearize_auto,
                                                      linearize_cuda)
from torch_linearize_cases import (chain, edge_cases, forest,
                                   linearize_model, resident_arena,
                                   with_garbage_tail)
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def full_iters(L):
    return list_rank.ceil_log2(L) + 1


def three_ways(case, n_iters, device_sort=False):
    """The JAX function, the plain version and linearize_auto on one
    case; asserts they agree and returns the rank."""
    obj, parent, ctr, actor, valid, sort_idx = case
    want = np.asarray(jax_list_rank.linearize(
        obj, parent, ctr, actor, valid, n_iters,
        sort_idx=None if device_sort else sort_idx))
    cols = [t(x) for x in (obj, parent, ctr, actor, valid)]
    si = None if device_sort else t(sort_idx)
    plain = list_rank.linearize(*cols, n_iters, sort_idx=si)
    auto = linearize_auto(*cols, n_iters, sort_idx=si)
    assert plain.dtype == auto.dtype == torch.int32
    assert (plain.numpy() == want).all()
    assert (auto.numpy() == want).all()
    model, esc_rounds, rank_rounds = linearize_model(
        obj, parent, valid, sort_idx, n_iters)
    assert (model == want).all()
    assert esc_rounds <= n_iters + 1 and rank_rounds <= n_iters
    return want


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
@pytest.mark.parametrize('device_sort', [False, True])
def test_forests_with_wide_fans(seed, device_sort):
    rs = np.random.RandomState(seed)
    case = forest(rs, n_objs=12, max_elems=90, fan=0.7, pad=9)
    rank = three_ways(case, full_iters(case[0].shape[0]), device_sort)
    valid = case[4]
    # every object's ranks are a permutation of 0 .. size - 1
    for o in np.unique(case[0][valid]):
        got = np.sort(rank[valid & (case[0] == o)])
        assert (got == np.arange(got.shape[0])).all()


@pytest.mark.parametrize('n_iters', [0, 1, 2, 5, 13])
def test_chain_of_4096_at_every_round_count(n_iters):
    case = chain(4096)
    rank = three_ways(case, n_iters)
    if n_iters < full_iters(4096):
        # too few rounds: the partial ranks, not the list's order
        assert (rank != np.arange(4096)).any()
    else:
        assert (rank == np.arange(4096)).all()


@pytest.mark.parametrize('seed', [4, 5])
def test_invalid_tail_with_garbage(seed):
    rs = np.random.RandomState(seed)
    case = with_garbage_tail(rs, forest(rs, 6, 60), 40)
    three_ways(case, 9)
    three_ways(case, 2, device_sort=True)


def test_resident_arena_with_stale_tail():
    rs = np.random.RandomState(6)
    case = resident_arena(rs, 700, 1024)
    three_ways(case, 11, device_sort=True)
    three_ways(case, 3)


@pytest.mark.parametrize('valid', [True, False])
def test_one_element(valid):
    case = [np.array([x], np.int32) for x in (0, -1, 1, 0)] + \
        [np.array([valid]), np.array([0], np.int32)]
    assert three_ways(case, 1).tolist() == [0 if valid else -1]
    three_ways(case, 0)


def test_model_at_the_routes_edges():
    """The kernel's algorithm at the edge cases `chip_smoke.py` runs on
    the card (route (a)'s limit and one above, L = 1, short n_iters on
    chains, garbage tails), against the plain version."""
    for label, case, n_iters in edge_cases(np.random.RandomState(7)):
        obj, parent, ctr, actor, valid, sort_idx = case
        want = list_rank.linearize(*[t(x) for x in case[:5]], n_iters,
                                   sort_idx=t(sort_idx)).numpy()
        got = linearize_model(obj, parent, valid, sort_idx, n_iters)[0]
        assert (got == want).all(), label


def test_model_stops_early_at_the_fixpoint():
    """A round that changes nothing ends the loop: far more rounds than
    the chain needs cost no more rounds and give the same ranks."""
    case = chain(1000)
    want = list_rank.linearize(*[t(x) for x in case[:5]], 200,
                               sort_idx=t(case[5])).numpy()
    got, esc_rounds, rank_rounds = linearize_model(
        case[0], case[1], case[4], case[5], 200)
    assert (got == want).all() and (got == np.arange(1000)).all()
    assert esc_rounds <= full_iters(1000) + 1
    assert rank_rounds <= full_iters(1000) + 1


def _good():
    case = forest(np.random.RandomState(8), 3, 20)
    return [t(x) for x in case[:5]], t(case[5])


def test_cuda_wrapper_rejects_cpu_tensors():
    cols, si = _good()
    with pytest.raises(ValueError, match='CUDA'):
        linearize_cuda(*cols, 4, sort_idx=si)
    with pytest.raises(ValueError, match='CUDA'):
        linearize_cuda(*cols, 4)


@pytest.mark.parametrize('which,bad', [
    (0, lambda x: x.to(torch.int64)),
    (1, lambda x: x.to(torch.float32)),
    (2, lambda x: x[:-1]),
    (3, lambda x: x.to(torch.int16)),
    (4, lambda x: x.to(torch.int32)),
    (4, lambda x: x[1:]),
    (0, lambda x: x[None]),
    (5, lambda x: x.to(torch.int64)),
    (5, lambda x: x[:-2]),
])
def test_cuda_wrapper_rejects_bad_dtypes_and_shapes(which, bad):
    cols, si = _good()
    if which == 5:
        si = bad(si)
    else:
        cols[which] = bad(cols[which])
    with pytest.raises(ValueError):
        linearize_cuda(*cols, 4, sort_idx=si)


@pytest.mark.parametrize('n_iters', [-1, 2.5, True, None])
def test_cuda_wrapper_rejects_bad_round_counts(n_iters):
    cols, si = _good()
    with pytest.raises(ValueError, match='n_iters'):
        linearize_cuda(*cols, n_iters, sort_idx=si)


def test_auto_raises_on_a_meta_tensor():
    cols = [torch.zeros(8, dtype=torch.int32, device='meta')
            for _ in range(4)] + [torch.zeros(8, dtype=torch.bool,
                                              device='meta')]
    with pytest.raises(ValueError, match='meta'):
        linearize_auto(*cols, 4)


def test_kernel_is_built_from_its_source():
    entry = _build.KERNELS['linearize']
    assert set(entry) == {'amtpu_torch_linearize',
                          'amtpu_torch_linearize_scratch'}
    with open(os.path.join(_build.CSRC, 'linearize.cu')) as f:
        src = f.read()
    for name in entry:
        assert 'extern "C" ' in src and name + '(' in src
    assert 'cudaLaunchCooperativeKernel' in src


#: the two modules that may call the plain `list_rank.linearize`
PLAIN_LINEARIZE_OK = {'automerge_tpu_torch/ops/list_rank.py',
                      'automerge_tpu_torch/ops/linearize_kernel.py'}


def plain_linearize_calls(path):
    """Lines of `path` that call `list_rank.linearize` directly, by any
    name its imports give it."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    modules, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ''
            for a in node.names:
                if a.name == 'list_rank':
                    modules.add(a.asname or a.name)
                elif mod.endswith('list_rank') and a.name == 'linearize':
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith('list_rank'):
                    modules.add(a.asname or a.name)
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in funcs:
            hits.append(node.lineno)
        elif isinstance(f, ast.Attribute) and f.attr == 'linearize' and \
                isinstance(f.value, ast.Name) and f.value.id in modules:
            hits.append(node.lineno)
    return hits


def test_no_port_module_calls_the_plain_linearize():
    """Every device path reaches the kernel through `linearize_auto`."""
    files = glob.glob(os.path.join(ROOT, 'automerge_tpu_torch', '**',
                                   '*.py'), recursive=True)
    bad = {}
    for path in files:
        rel = os.path.relpath(path, ROOT)
        if rel not in PLAIN_LINEARIZE_OK and plain_linearize_calls(path):
            bad[rel] = plain_linearize_calls(path)
    assert not bad, bad


def test_the_scan_finds_a_plain_call(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('from ..ops import list_rank\n'
                     'from .list_rank import linearize as lin\n'
                     'list_rank.linearize(a)\nlin(b)\n'
                     'list_rank.ceil_log2(3)\n')
    assert plain_linearize_calls(str(probe)) == [3, 4]
