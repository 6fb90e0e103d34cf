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
- `lexsort_model`, the kernel's algorithm in numpy (the route by L, the
  plan, the register order's per-doc routes where every group id is in
  range, the radix passes with each CTA's or tile's local ranks, the
  cluster's exchange and the grid's one sweep and look-back, skipped
  passes, the carried key window), against both, on an H100 (clusters
  of 16, a grid of 132), with clusters of 8 and a small grid, and with
  every L on a small grid; the model's grid at 9-bit digits; the warp
  route's narrow and wide keys;
- the route seams: the cluster's capacity and one row above it, a group
  id at n_groups or -2 against its in-range twin, an id keyed into
  another doc's rows (why the in-range decision is global);
- the wrappers' checks and readout, and that the card paths reach the
  kernel.

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
from torch_lexsort_cases import (CLUSTER_ROWS, NARROW_BITS, TILE_MAX,
                                 capacity_cases,
                                 groups_in_range, lexsort_model,
                                 register_cases, register_reference,
                                 route_of, sibling_cases, sibling_reference)
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIBLING = sibling_cases(np.random.RandomState(18))
REGISTER = register_cases(np.random.RandomState(19))
#: (largest cluster, grid blocks) of the model's cards, by test id: an
#: H100, clusters of 8 on a small grid, every L on a small grid
SIBLING_CARDS = {'132': (16, 132), '5': (8, 5), 'grid-3': (0, 3)}
REGISTER_CARDS = {'132': (16, 132), '3': (0, 3), 'c8-5': (8, 5)}


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


@pytest.mark.parametrize('card', list(SIBLING_CARDS.values()),
                         ids=list(SIBLING_CARDS))
@pytest.mark.parametrize('label,case', SIBLING, ids=[c[0] for c in SIBLING])
def test_sibling_model_matches_jax(label, case, card):
    got, info = lexsort_model('sibling', case, *card)
    assert (got == jax_sibling(*case)).all()
    L = case[0].shape[0]
    assert info['route'] == route_of(L, *card)[0]
    assert info['passes'] <= 16 and info['run'] <= info['passes']


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


@pytest.mark.parametrize('card', list(REGISTER_CARDS.values()),
                         ids=list(REGISTER_CARDS))
@pytest.mark.parametrize('label,case', REGISTER,
                         ids=[c[0] for c in REGISTER])
def test_register_model_matches_plain_and_jax(label, case, card):
    rg, rt, n_groups = case
    got, info = lexsort_model('register', case, *card)
    plain = mesh.register_order(t(rg), t(rt), n_groups).numpy()
    assert (got == plain).all()
    if groups_in_range(rg, n_groups):
        assert (got == jax_register(rg, rt)).all()
    assert info['passes'] <= 12
    D, T = rg.shape
    if info['in_range'] != int(groups_in_range(rg, n_groups) and D * T > 0):
        raise AssertionError(info)
    # the per-doc routes exactly where every id is in range
    if info['route'] in ('warp', 'block'):
        assert groups_in_range(rg, n_groups)
    elif groups_in_range(rg, n_groups) and D * T:
        assert T > 32 and T > info['rows'] or info['bits'] > 64


@pytest.mark.parametrize('label,case', SIBLING[3:] + REGISTER[2:],
                         ids=[c[0] for c in SIBLING[3:] + REGISTER[2:]])
def test_grid_model_at_nine_bit_digits(label, case):
    """The model's grid at 9-bit digits (the kernel's are 8 bits,
    `kDigitBits`: a 9-bit grid measured slower on an H100): the passes
    follow the width; every L on a grid of 4 blocks."""
    site = 'sibling' if len(case) == 5 else 'register'
    got, info = lexsort_model(site, case, 0, 4, grid_bits=9)
    assert info['route'] in ('grid', 'warp', 'block')
    if info['route'] == 'grid':
        assert info['digit_bits'] == 9
        assert info['passes'] == -(-info['bits'] // 9)
    want = jax_sibling(*case) if site == 'sibling' else \
        mesh.register_order(*[t(x) if isinstance(x, np.ndarray) else x
                              for x in case]).numpy()
    assert (got == want).all()


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
    """20,000 rows over CTAs: on an H100 a cluster of 16 CTAs of 1,250
    rows (pow2ceil(20,000 / 1,024) capped at 16), with clusters of 8 CTAs
    of 2,500; every L on a grid of 5, 5 tiles of 4,000, and of 132, 132
    tiles of 152; each pass pays two cluster barriers or one grid
    barrier; before its passes the cluster pays two (its peers started,
    the ranges) and the grid two (the ranges, the totals)."""
    case = dict(SIBLING)['typed at its head, 20,000 rows (route b)']
    for card, route, ctas, rows, tiles in (
            ((16, 132), 'cluster', 16, 1250, 0),
            ((8, 132), 'cluster', 8, 2500, 0),
            ((0, 5), 'grid', 5, 4000, 5), ((0, 132), 'grid', 132, 152, 132)):
        got, info = lexsort_model('sibling', case, *card)
        assert (got == jax_sibling(*case)).all()
        assert (info['route'], info['ctas'], info['rows'], info['tiles']) \
            == (route, ctas, rows, tiles)
        assert info['passes'] == 2 and info['skipped'] == []
        assert info['barriers'] == (2 + 2 * 2 if route == 'cluster'
                                    else 2 + 1)
    assert route_of(CLUSTER_ROWS + 1) == ('cluster', 2, 513)
    assert route_of(16 * TILE_MAX) == ('cluster', 16, TILE_MAX)
    assert route_of(16 * TILE_MAX + 1) == ('grid', 132, 497)
    assert route_of(16 * TILE_MAX + 1, 8) == ('grid', 132, 497)
    assert route_of(8 * TILE_MAX, 8) == ('cluster', 8, TILE_MAX)


@pytest.mark.parametrize('card', [(16, 132), (8, 132)])
def test_model_at_the_cluster_capacity_and_one_above(card):
    """The cluster's capacity (its CTAs of a full tile) takes the cluster;
    one row more takes the grid; both bit-equal to jnp.lexsort."""
    for label, case in capacity_cases(np.random.RandomState(20), card[0]):
        L = case[0].shape[0]
        got, info = lexsort_model('sibling', case, *card)
        assert (got == jax_sibling(*case)).all(), label
        assert info['route'] == ('cluster' if L <= card[0] * TILE_MAX
                                 else 'grid'), label
        assert info['rows'] == (TILE_MAX if info['route'] == 'cluster'
                                else -(-L // card[1]))


@pytest.mark.parametrize('value,route', [(9, 'cluster'), (8, 'warp'),
                                         (-2, 'cluster'), (-1, 'warp')])
def test_one_row_outside_the_groups_turns_the_per_doc_route_off(value,
                                                                 route):
    """A single row at n_groups or at -2 in 64 docs of 32 rows: the per-doc
    route gives way to the radix; n_groups - 1 and -1 keep it; each
    bit-equal to the plain version."""
    label = {9: 'a row at n_groups', 8: 'a row at n_groups - 1',
             -2: 'a row at -2', -1: 'a row at -1'}[value]
    rg, rt, n = dict(REGISTER)[label + ', 64 docs x 32']
    assert (rg == value).sum() >= 1 and n == 9
    got, info = lexsort_model('register', (rg, rt, n))
    assert info['route'] == route
    assert info['in_range'] == int(route == 'warp')
    assert (got == mesh.register_order(t(rg), t(rt), n).numpy()).all()


def test_in_range_decision_is_global():
    """Doc 0's id 34 = 5 (n_groups + 1) - 1 keys as doc 5's padding: doc 5
    holds only in-range ids, yet its rows in the flattened order are not
    its own per-doc sort (a decision each block made from its own docs
    would be wrong); the kernel's route sees the whole input and takes
    the radix."""
    rg, rt, n = dict(REGISTER)["an id keyed into another doc's rows"]
    T = rg.shape[1]
    plain = mesh.register_order(t(rg), t(rt), n).numpy()
    own = np.lexsort((rt[5], rg[5])) + 5 * T
    assert groups_in_range(rg[5:6], n) and not groups_in_range(rg, n)
    assert not (plain[5 * T:6 * T] == own).all()
    assert 0 * T + 7 in plain[5 * T:6 * T]
    got, info = lexsort_model('register', (rg, rt, n))
    assert info['route'] == 'cluster' and (got == plain).all()


def test_a_doc_of_a_warp_and_one_row_takes_the_block_route():
    """T = 32: a warp a doc; T = 33: batches of whole docs a CTA."""
    for label, route in (('docs of a warp, 300 x 32', 'warp'),
                         ('docs of a warp and one row, 40 x 33', 'block')):
        rg, rt, n = dict(REGISTER)[label]
        got, info = lexsort_model('register', (rg, rt, n))
        assert info['route'] == route, label
        assert (got == jax_register(rg, rt)).all(), label


@pytest.mark.parametrize('label,narrow', [
    ('docs of a warp, 300 x 32', True),
    ('scaling-like, 512 docs x 32', True),
    ('docs of a warp, times at INT_MIN and INT_MAX, 64 x 32', False)])
def test_warp_route_keys_narrow_and_wide(label, narrow):
    """A warp a doc ranks 32-bit keys, the lane below (group, time), where
    their widths fit NARROW_BITS, else 64-bit keys and lanes (times that
    span every int32); both bit-equal to the JAX step's sort."""
    rg, rt, n = dict(REGISTER)[label]
    got, info = lexsort_model('register', (rg, rt, n))
    assert info['route'] == 'warp' and info['narrow'] is narrow
    assert info['barriers'] == 2  # its peers started; the ranges
    assert (got == jax_register(rg, rt)).all()


def _sibling_cols():
    case = dict(SIBLING)['forest L=33']
    return [t(x) for x in case]


def test_readout_names_its_words():
    info = torch.zeros(lexsort_kernel.INFO_WORDS, dtype=torch.int32)
    info[:12] = torch.tensor([3, 16, 8, 15, 2, 2, 0b101, 1, 1, 128, 0, 16])
    info[12:] = torch.arange(100, 110)
    ro = lexsort_kernel.readout(info)
    assert ro['route'] == 'block' and ro['ctas'] == 16
    assert ro['skipped'] == [0, 2] and ro['in_range'] == 1
    assert ro['plan_ns'] == 100 and ro['pass_ns'] == [101, 102]
    assert ro['end_ns'] == 109


@pytest.mark.parametrize('bad', [
    lambda: torch.zeros(lexsort_kernel.INFO_WORDS, dtype=torch.int64),
    lambda: torch.zeros(lexsort_kernel.INFO_WORDS - 1, dtype=torch.int32),
    lambda: torch.zeros(2 * lexsort_kernel.INFO_WORDS,
                        dtype=torch.int32)[::2],
])
def test_cuda_wrappers_reject_a_bad_readout(bad):
    with pytest.raises(ValueError):
        lexsort_kernel._check_info(bad(), torch.device('cpu'))


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
    assert 'cudaLaunchKernelEx' in src and 'cudaLaunchAttributeClusterDimension' in src
    assert 'map_shared_rank' in src
    for const, value in (('kTileMax', None),
                         ('kClusterRows', CLUSTER_ROWS),
                         ('kDigitBits', 8), ('kNarrowBits', NARROW_BITS),
                         ('kClusterMax', 16), ('kSteps', 8),
                         ('kThreads', 512)):
        m = re.search(r'constexpr int %s = ([^;]+);' % const, src)
        assert m, const
        if value is not None:
            assert int(m.group(1)) == value, const
    assert lexsort_kernel.TILE_MAX == TILE_MAX == 512 * 8
    assert lexsort_kernel.CLUSTER_ROWS == CLUSTER_ROWS
    words = re.search(r'enum Info \{([^}]*)\}', src).group(1)
    names = [w.strip().split('=')[0].strip() for w in words.split(',')
             if w.strip()]
    assert names[-1] == 'kInfoWords'
    assert len(lexsort_kernel.INFO_FIELDS) == names.index('kInfoPlanNs')
    assert lexsort_kernel.INFO_WORDS == len(lexsort_kernel.INFO_FIELDS) \
        + int(re.search(r'kStampPasses = (\d+);', src).group(1)) + 2


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
