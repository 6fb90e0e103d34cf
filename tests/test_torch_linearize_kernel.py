"""The port's linearize kernel route (`ops/linearize_kernel.py`,
`csrc/linearize.cu`) on the CPU: the same numpy inputs go through the
JAX function `automerge_tpu/ops/list_rank.py::linearize`, the port's
plain version and `linearize_auto`, and all three must agree exactly
(integer ranks: the tolerance is equality), with the host's sibling sort
and with the sort on the device.  The round counts are pinned: n_iters
of 0, 1, 2 and too few for a chain give the plain version's partial
ranks, which the kernel must reproduce.  The numpy models of
`tests/torch_linearize_cases.py` are held to the plain version on every
case: the rounds route (`linearize_model`, with its early stop), the
list-ranking route (`tour_model`: the Euler tour, hashed splitters, two
walks, the splitters ranked in one block or through a second level) on
both the one-block and the grid layout, and the route rule
(`route_of`), whose choice each case states.  The CUDA wrapper's checks
run here; the kernel itself runs in `chip_smoke.py` on the card."""

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
from torch_linearize_cases import (
    END, INFO_BARRIERS, INFO_GRID, INFO_ROUTE, INFO_TOP, INFO_WALK1,
    INFO_WALK2, INFO_WORDS, L2_MIN_LOG, MAX_TOUR_L, ONE_CTA_MAX, ROUTE_ROUNDS,
    ROUTE_TOUR, SALT1, SALT2, TOP_CAP, TOUR_LOG_K, chain, edge_cases,
    forest, forest_of_size, grid_log_k, kernel_model, linearize_model, mix32,
    resident_arena, route_of, tour_cases, tour_model, with_garbage_tail)
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def full_iters(L):
    return list_rank.ceil_log2(L) + 1


def three_ways(case, n_iters, device_sort=False, route=None):
    """The JAX function, the plain version and linearize_auto on one
    case; asserts they agree, that both routes' models give the same
    ranks and (`route`) which route the kernel takes; returns the
    rank."""
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
    got, info = kernel_model(obj, parent, valid, sort_idx, n_iters)
    assert (got == want).all()
    if info[INFO_ROUTE] == ROUTE_TOUR:
        # the grid's layout (a second level) on the same case
        assert (tour_model(obj, parent, valid, sort_idx, 0)[0] == want).all()
    if route is not None:
        assert info[INFO_ROUTE] == route
    return want


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
@pytest.mark.parametrize('device_sort', [False, True])
def test_forests_with_wide_fans(seed, device_sort):
    rs = np.random.RandomState(seed)
    case = forest(rs, n_objs=12, max_elems=90, fan=0.7, pad=9)
    rank = three_ways(case, full_iters(case[0].shape[0]), device_sort,
                      route=ROUTE_TOUR)
    valid = case[4]
    # every object's ranks are a permutation of 0 .. size - 1
    for o in np.unique(case[0][valid]):
        got = np.sort(rank[valid & (case[0] == o)])
        assert (got == np.arange(got.shape[0])).all()


@pytest.mark.parametrize('n_iters', [0, 1, 2, 5, 13])
def test_chain_of_4096_at_every_round_count(n_iters):
    case = chain(4096)
    # the tour where n_iters >= ceil_log2(4096): the rounds converge
    rank = three_ways(case, n_iters, route=ROUTE_TOUR if n_iters >= 12
                      else ROUTE_ROUNDS)
    if n_iters < full_iters(4096):
        # too few rounds: the partial ranks, not the list's order
        assert (rank != np.arange(4096)).any()
    else:
        assert (rank == np.arange(4096)).all()


@pytest.mark.parametrize('seed', [4, 5])
def test_invalid_tail_with_garbage(seed):
    rs = np.random.RandomState(seed)
    case = with_garbage_tail(rs, forest(rs, 6, 60), 40)
    # objects of at most 60 rows: 9 rounds are enough, 2 are not
    three_ways(case, 9, route=ROUTE_TOUR)
    three_ways(case, 2, device_sort=True, route=ROUTE_ROUNDS)


def test_resident_arena_with_stale_tail():
    rs = np.random.RandomState(6)
    case = resident_arena(rs, 700, 1024)
    three_ways(case, 11, device_sort=True, route=ROUTE_TOUR)
    three_ways(case, 3, route=ROUTE_ROUNDS)


@pytest.mark.parametrize('valid', [True, False])
def test_one_element(valid):
    case = [np.array([x], np.int32) for x in (0, -1, 1, 0)] + \
        [np.array([valid]), np.array([0], np.int32)]
    assert three_ways(case, 1, route=ROUTE_TOUR).tolist() == \
        [0 if valid else -1]
    three_ways(case, 0, route=ROUTE_TOUR)


TOUR_CASES = tour_cases(np.random.RandomState(19))


@pytest.mark.parametrize('i', range(len(TOUR_CASES)),
                         ids=[c[0].replace(' ', '-') for c in TOUR_CASES])
def test_tour_cases(i):
    """The shapes the route rule and the tour must survive (a comb, deep
    nesting, heads only, one-element objects, malformed parents, n_iters
    at the rule's threshold and one below), each on the route it
    names."""
    _label, case, n_iters, route = TOUR_CASES[i]
    three_ways(case, n_iters, route=route)
    three_ways(case, n_iters, device_sort=True, route=route)


#: the route each of `edge_cases` takes: the chains' short n_iters take
#: the rounds, everything else the tour
EDGE_ROUTES = [ROUTE_TOUR] * 4 + [ROUTE_ROUNDS] * 8 + [ROUTE_TOUR] * 2


def test_model_at_the_routes_edges():
    """The kernel's algorithm at the edge cases `chip_smoke.py` runs on
    the card (route (a)'s limit and one above, L = 1, short n_iters on
    chains, garbage tails), against the plain version."""
    cases = edge_cases(np.random.RandomState(7))
    assert len(cases) == len(EDGE_ROUTES)
    for (label, case, n_iters), route in zip(cases, EDGE_ROUTES):
        obj, parent, ctr, actor, valid, sort_idx = case
        want = list_rank.linearize(*[t(x) for x in case[:5]], n_iters,
                                   sort_idx=t(sort_idx)).numpy()
        got = linearize_model(obj, parent, valid, sort_idx, n_iters)[0]
        assert (got == want).all(), label
        got, info = kernel_model(obj, parent, valid, sort_idx, n_iters)
        assert (got == want).all(), label
        assert info[INFO_ROUTE] == route, label
        assert info[INFO_GRID] == (obj.shape[0] > ONE_CTA_MAX), label


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


def test_splitters_one_down_one_up_a_window():
    """Each window of 2**TOUR_LOG_K rows holds one down and one up
    splitter (a plain stride of the half-edge index would put every
    splitter on one parity, and a chain's ups or downs would then run
    unsplit)."""
    K = 1 << TOUR_LOG_K
    for L in (1, 7, 8, 9, 1000, 1003):
        h = np.arange(2 * L)
        slot = ((h >> 1) >> TOUR_LOG_K) * 2 + (h & 1)
        split = ((h >> 1) & (K - 1)) == (mix32(slot + SALT1) & (K - 1))
        for w in range(L // K):
            sel = split[16 * w:16 * w + 16]
            assert sel[0::2].sum() == 1 and sel[1::2].sum() == 1, (L, w)
        assert split.sum() <= 2 * -(-L // K)


@pytest.mark.parametrize('L', [ONE_CTA_MAX + 1, 40000, 150000])
def test_grid_layout_is_four_barriers_and_chains_walk_two_windows(L):
    """Route (b)'s tour runs 4 grid barriers at every L; on a chain every
    walk meets a splitter within two windows, at both levels; the ranked
    splitters fit one block's shared memory."""
    case = chain(L)
    want = np.arange(L)
    rank, info = kernel_model(case[0], case[1], case[4], case[5],
                              full_iters(L))
    assert (rank == want).all()
    assert info[INFO_ROUTE] == ROUTE_TOUR and info[INFO_GRID] == 1
    assert info[INFO_BARRIERS] == 4
    lk = grid_log_k(L)
    assert info[INFO_WALK1] <= 2 << lk
    M1 = 2 * -(-L // (1 << lk))
    log_k2 = max(L2_MIN_LOG, list_rank.ceil_log2(-(-M1 // (TOP_CAP // 2))))
    assert info[INFO_WALK2] <= 2 << log_k2
    assert info[INFO_TOP] <= TOP_CAP


def test_forest_walks_on_both_layouts():
    """A forest of wide fans above route (a)'s limit, ranked on both
    layouts of the tour, equal to the plain version."""
    rs = np.random.RandomState(11)
    case = forest_of_size(rs, 30000, 40)
    obj, parent, ctr, actor, valid, sort_idx = case
    want = list_rank.linearize(*[t(x) for x in case[:5]], 16,
                               sort_idx=t(sort_idx)).numpy()
    for one_cta_max in (ONE_CTA_MAX, 40000, 0):
        assert (tour_model(obj, parent, valid, sort_idx,
                           one_cta_max)[0] == want).all()


def test_many_objects_rank_past_the_shared_top():
    """One-element objects: every slot walker ends its object's tour, so
    each is a tail and a level-2 splitter; more than TOP_CAP of them
    are ranked through global memory (the same block), still exact."""
    n = 120000
    case = [np.arange(n, dtype=np.int32), np.full(n, -1, np.int32),
            np.ones(n, np.int32), np.zeros(n, np.int32), np.ones(n, bool)]
    case.append(np.arange(n, dtype=np.int32))
    rank, info = kernel_model(case[0], case[1], case[4], case[5], 0)
    assert info[INFO_ROUTE] == ROUTE_TOUR and info[INFO_TOP] > TOP_CAP
    assert (rank == 0).all()


@pytest.mark.parametrize('seed', range(6))
def test_route_rule_takes_the_tour_only_where_the_rounds_converge(seed):
    """The rule's proof, checked: at every n_iters from 0 up, where
    `route_of` takes the tour the plain version's ranks are its
    converged ranks (a row's preorder position); the rule's threshold
    is ceil_log2 of the largest object."""
    rs = np.random.RandomState(40 + seed)
    case = forest(rs, rs.randint(1, 8), rs.randint(2, 600),
                  fan=rs.rand(), pad=rs.randint(0, 9))
    obj, parent, ctr, actor, valid, sort_idx = case
    cols = [t(x) for x in case[:5]]
    converged = list_rank.linearize(*cols, 40, sort_idx=t(sort_idx)).numpy()
    _route, max_size = route_of(obj, parent, valid, 0)
    for n_iters in range(0, list_rank.ceil_log2(max_size) + 2):
        route = route_of(obj, parent, valid, n_iters)[0]
        assert route == (ROUTE_TOUR if n_iters >= list_rank.ceil_log2(
            max_size) else ROUTE_ROUNDS)
        if route == ROUTE_TOUR:
            got = list_rank.linearize(*cols, n_iters,
                                      sort_idx=t(sort_idx)).numpy()
            assert (got == converged).all(), n_iters


def _kernel_constant(src, name):
    import re
    m = re.search(r'constexpr [\w ]+ %s = ([^;]+);' % name, src)
    assert m, name
    v = m.group(1).rstrip('u')
    return int(v.split('<<')[0].strip().replace('int64_t(1)', '1'), 0) \
        << (int(v.split('<<')[1]) if '<<' in v else 0)


def test_model_constants_are_the_kernels():
    """The numpy model mirrors `csrc/linearize.cu`: route (a)'s limit,
    the windows, the shared top's capacity, the salts, the tour's
    largest L, END and the readout's size."""
    from automerge_tpu_torch.ops import linearize_kernel
    with open(os.path.join(_build.CSRC, 'linearize.cu')) as f:
        src = f.read()
    for name, want in (('kOneCtaMax', ONE_CTA_MAX),
                       ('kTourLogK', TOUR_LOG_K), ('kL2MinLog', L2_MIN_LOG),
                       ('kTopCap', TOP_CAP), ('kSalt1', SALT1),
                       ('kSalt2', SALT2), ('kMaxTourL', MAX_TOUR_L),
                       ('kEnd', END), ('kInfoWords', INFO_WORDS)):
        assert _kernel_constant(src, name) == want, name
    assert linearize_kernel.INFO_WORDS == INFO_WORDS
    assert linearize_kernel.MAX_L == MAX_TOUR_L - 1


def test_main_paths_take_the_tour(monkeypatch):
    """Every linearize call of the CPU pool (config 3, a config-1 text),
    the step (a text workload, the scaling workload) and the engine is
    a well-formed forest with enough rounds: on the card each takes the
    tour."""
    import random
    from automerge_tpu_torch import workloads
    from automerge_tpu_torch.native import NativeDocPool
    from automerge_tpu_torch.ops import linearize_kernel
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    from automerge_tpu_torch.parallel.engine import TPUDocPool
    calls = {}
    path = ['']
    plain = linearize_kernel.linearize

    def spy(obj, parent, ctr, actor, valid, n_iters, sort_idx=None):
        calls.setdefault(path[0], []).append(route_of(
            obj.numpy(), parent.numpy(), valid.numpy(), n_iters)[0])
        return plain(obj, parent, ctr, actor, valid, n_iters,
                     sort_idx=sort_idx)
    monkeypatch.setattr(linearize_kernel, 'linearize', spy)
    path[0] = 'pool'
    NativeDocPool(device='cpu').apply_batch(
        workloads.build_config_3(random.Random(3), n_docs=16))
    NativeDocPool(device='cpu').apply_batch(
        workloads.build_config_1(random.Random(3), chars=1200, per_change=40))
    for path[0], wl in (('step text', mesh_encode.demo_text_workload(4)),
                        ('step scaling', mesh_encode.scaling_workload(8))):
        batch, meta = mesh_encode.encode_batch(wl)
        mesh.single_step(batch, list_rank.ceil_log2(
            max(meta['max_arena'], 1)) + 1, device='cpu')
    path[0] = 'engine'
    TPUDocPool(device='cpu').apply_batch(
        workloads.build_config_3(random.Random(4), n_docs=8))
    assert set(calls) == {'pool', 'step text', 'step scaling', 'engine'}
    assert all(r == ROUTE_TOUR for routes in calls.values()
               for r in routes), calls


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


@pytest.mark.parametrize('bad', [
    lambda: torch.zeros(INFO_WORDS, dtype=torch.int64),
    lambda: torch.zeros(INFO_WORDS - 1, dtype=torch.int32),
    lambda: torch.zeros(2 * INFO_WORDS, dtype=torch.int32)[::2],
])
def test_cuda_wrapper_rejects_a_bad_readout(bad):
    cols, si = _good()
    with pytest.raises(ValueError, match='info'):
        linearize_cuda(*cols, 4, sort_idx=si, info=bad())


def test_cuda_wrapper_rejects_an_arena_past_the_tours_indices():
    cols = [torch.zeros(MAX_TOUR_L, dtype=torch.int32, device='meta')
            for _ in range(4)] + [torch.zeros(MAX_TOUR_L, dtype=torch.bool,
                                              device='meta')]
    with pytest.raises(ValueError, match='L <='):
        linearize_cuda(*cols, 4)


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
