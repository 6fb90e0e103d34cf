"""The port's resolver step and its encoder against the JAX package's.

`automerge_tpu_torch.parallel.mesh_encode.encode_batch` must give the
arrays and the `meta` of the JAX encoder; `mesh.single_step(...,
device='cpu')` (the kernels' plain versions over docs flattened into one
array) must give every output key of the JAX `single_step` (vmapped per
doc), element for element, padding rows included; and
`verify_against_pool` must pass through the port's own engine.  The
whole-doc dominance indexes are held to the JAX function on random
inputs at chunks 16 and 128, and so is the model of the card's route
(`tests/torch_step_cases.route_model`: the per-doc regroup flag, the
dense positions, each chunk's windowed start-state prefix and the
in-chunk term of `csrc/dominance_indexes.cu`).
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.ops import list_rank as JL
from automerge_tpu.parallel import mesh as JM
from automerge_tpu.parallel import mesh_encode as JE
from automerge_tpu_torch import trace
from automerge_tpu_torch.ops import dominance_kernel, list_rank
from automerge_tpu_torch.parallel import mesh as M
from automerge_tpu_torch.parallel import mesh_encode as E
from tests.torch_step_cases import (SCAN_SHAPES, dominance_indexes_case,
                                    dominance_scan_case, route_model)
from torch_threads import cap_threads

cap_threads()

ROOT = '00000000-0000-0000-0000-000000000000'
OUT_KEYS = ('order', 'doc_clock', 'frontier', 'alive_after', 'winner',
            'conflicts', 'visible_before', 'overflow', 'rank', 'indexes')
STEP_SPANS = ('step.uploads', 'step.schedule', 'step.registers',
              'step.linearize', 'step.op_metadata', 'step.route')


def encode_both(workload, **kw):
    batch, meta = E.encode_batch(workload, **kw)
    jbatch, jmeta = JE.encode_batch(workload, **kw)
    assert set(batch) == set(jbatch)
    for k in batch:
        assert batch[k].dtype == jbatch[k].dtype, k
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    assert meta == jmeta
    return batch, meta


def step_both(batch, n_iters, chunk):
    out = M.single_step(batch, n_iters, chunk=chunk, device='cpu')
    want = JM.single_step(batch, n_linearize_iters=n_iters, chunk=chunk)
    assert set(out) == set(want)
    for k in OUT_KEYS:
        got = out[k].numpy()
        ref = np.asarray(want[k])
        assert got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    return out


def run_workload(workload, chunk=16, **kw):
    batch, meta = encode_both(workload, **kw)
    n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
    out = step_both(batch, n_iters, chunk)
    E.verify_against_pool(workload, meta, out, device='cpu')
    return batch, meta, out


@pytest.mark.parametrize('chunk', [16, 128])
def test_single_step_demo_batch(chunk):
    step_both(M.demo_batch(), n_iters=4, chunk=chunk)


def test_single_step_text_workload():
    run_workload(E.demo_text_workload(4))


def test_scaling_workload_encodes_equally():
    batch, meta = encode_both(E.scaling_workload(8))
    n_iters = list_rank.ceil_log2(meta['max_arena']) + 1
    step_both(batch, n_iters, 128)


def test_map_workload():
    run_workload(E.demo_map_workload())


def test_table_workload():
    run_workload(E.demo_table_workload())


def test_shuffled_and_duplicated_delivery():
    workload = E.demo_map_workload(n_docs=2)
    rng = random.Random(11)
    shuffled = {}
    for d, chs in workload.items():
        chs = list(chs) + [dict(chs[0])]
        rng.shuffle(chs)
        shuffled[d] = chs
    run_workload(shuffled)


def test_history_continuation_and_sp_padding():
    full = E.demo_map_workload(n_docs=2, n_rounds=2)
    history = {d: [c for c in chs if c['seq'] == 1]
               for d, chs in full.items()}
    new = {d: [c for c in chs if c['seq'] == 2] for d, chs in full.items()}
    batch, meta = encode_both(new, history_by_doc=history, sp=3)
    step_both(batch, list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1, 16)
    E.verify_against_pool({d: history[d] + new[d] for d in full}, meta,
                          M.single_step(batch, 4, device='cpu'),
                          device='cpu')


def test_same_change_duplicate_assigns():
    workload = {0: [{'actor': 'A', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': 'T'},
        {'action': 'ins', 'obj': 'T', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 'T', 'key': 'A:1', 'value': 'x'},
        {'action': 'set', 'obj': 'T', 'key': 'A:1', 'value': 'y'},
        {'action': 'del', 'obj': 'T', 'key': 'A:1'},
        {'action': 'link', 'obj': ROOT, 'key': 't', 'value': 'T'}]}]}
    _, meta, out = run_workload(workload)
    assert out['alive_after'][0, meta['ops'][0][-1][0]] == 2


def test_route_workload_and_gaps():
    ok = E.demo_map_workload(n_docs=2)
    hot = {'hot': [{'actor': 'w%02d' % a, 'seq': 1, 'deps': {},
                    'ops': [{'action': 'set', 'obj': ROOT, 'key': 'k',
                             'value': a}]} for a in range(10)]}
    workload = dict(ok, **hot)
    mesh_docs, pool_docs = E.route_workload(workload)
    jmesh, jpool = JE.route_workload(workload)
    assert (mesh_docs, pool_docs) == (jmesh, jpool)
    bad = {0: [{'actor': 'A', 'seq': 2, 'deps': {}, 'ops': []}]}
    with pytest.raises(ValueError, match='missing dependencies'):
        E.encode_batch(bad)


def test_verify_catches_a_wrong_index():
    workload = E.demo_text_workload(2)
    batch, meta = E.encode_batch(workload)
    out = M.single_step(batch, 5, device='cpu')
    out['indexes'] = out['indexes'] + 1
    with pytest.raises(AssertionError):
        E.verify_against_pool(workload, meta, out, device='cpu')


def test_step_stages_and_post_upload_part():
    """`single_step` issues each stage inside its trace span
    (`step.uploads` through `step.route`), and its post-upload part
    (`step_tensors` on `upload_batch`, with the register groups' bound
    from the host's batch) gives its outputs."""
    batch = M.demo_batch()
    before = trace.snapshot()['spans']
    out = M.single_step(batch, 4, device='cpu')
    after = trace.snapshot()['spans']
    grew = {k for k in after
            if k.startswith('step.') and after[k] > before.get(k, -1.0)}
    assert grew == set(STEP_SPANS)
    assert M.n_groups_of(batch) == int(batch['rg'].max()) + 1
    again = M.step_tensors(M.upload_batch(batch, torch.device('cpu')),
                           M.n_groups_of(batch), 4)
    for k in OUT_KEYS:
        assert torch.equal(again[k], out[k]), k


def test_route_wrapper_refuses_cpu_tensors():
    case = [torch.from_numpy(x) for x in dominance_indexes_case(
        np.random.RandomState(3), 2, 8, 8, 1)]
    with pytest.raises(ValueError, match='CUDA'):
        dominance_kernel.dominance_indexes_cuda(*case)
    with pytest.raises(ValueError, match='CUDA'):
        dominance_kernel.dominance_indexes_cuda(*[x[0] for x in case])


def test_step_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='single_step.*CUDA'):
        M.single_step(M.demo_batch(), 4)


@pytest.mark.parametrize('chunk', [16, 128])
@pytest.mark.parametrize('D,L,T,n_obj', [(3, 40, 100, 3), (2, 300, 700, 5),
                                         (4, 17, 5, 1)])
def test_dominance_indexes(chunk, D, L, T, n_obj):
    rs = np.random.RandomState(D * 1000 + L + chunk)
    case = dominance_indexes_case(rs, D, L, T, n_obj)
    want = np.stack([np.asarray(JL.dominance_indexes(
        *[x[d] for x in case], chunk=chunk)) for d in range(D)])
    tt = [torch.from_numpy(x) for x in case]
    got = list_rank.dominance_indexes(*tt, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        list_rank.dominance_indexes(*[x[0] for x in tt], chunk=chunk)
        .numpy(), want[0])
    # the model of the card's route: every doc takes the fast branch, at
    # the kernel's chunk and window and at ones that cut these sizes finer
    for cut in ({}, dict(K=16, window=24)):
        routed, flags = route_model(case, scan_at(chunk), **cut)
        assert flags.all()
        np.testing.assert_array_equal(routed, want)


def scan_at(chunk):
    """One doc's chunk walk (the plain version) for `route_model`."""
    def scan(doc):
        return list_rank.dominance_indexes(
            *[torch.from_numpy(np.ascontiguousarray(x)) for x in doc],
            chunk=chunk).numpy()
    return scan


def test_dominance_indexes_inconsistent_inputs_are_not_regroupable():
    """Inputs whose counts depend on the chunking (an invalid op of a real
    object with a delta) do not take the route's fast branch: the
    model's flag is per doc, so only the doc that holds one turns."""
    case = dominance_indexes_case(np.random.RandomState(1), 2, 20, 40, 2)
    assert route_model(case, scan_at(128))[1].all()
    ov = case[7].copy()
    ov[0, 3] = False
    bad = case[:7] + (ov,)
    got, flags = route_model(bad, scan_at(128))
    assert list(flags) == [False, True]
    tt = [torch.from_numpy(x) for x in bad]
    np.testing.assert_array_equal(
        got, list_rank.dominance_indexes(*tt, chunk=128).numpy())


def test_config1_workload():
    """Config 1 (`workloads.build_config_1`, the copy of
    `bench.py::build_config_1`) through the encoder and the step, at 2,000
    of its 10,000 characters; the full doc equals the bench's."""
    import bench
    from automerge_tpu_torch import workloads
    full = workloads.build_config_1(random.Random(0))
    assert full == bench.build_config_1(random.Random(0))[0]
    assert workloads.op_count(full) == 20002
    run_workload(workloads.build_config_1(random.Random(0), chars=2000),
                 chunk=128)


@pytest.mark.parametrize('chunk', [16, 128])
@pytest.mark.parametrize('shape', SCAN_SHAPES)
def test_dominance_indexes_chunk_dependent_inputs(chunk, shape):
    """Inputs that do not regroup (the chunk-scan kernel's on the card):
    the plain version still equals the JAX function at each chunk, and
    the two chunks give different counts somewhere."""
    D = shape[0]
    case = dominance_scan_case(np.random.RandomState(sum(shape)), *shape)
    tt = [torch.from_numpy(x) for x in case]
    assert not route_model(case, scan_at(chunk))[1].any()
    want = np.stack([np.asarray(JL.dominance_indexes(
        *[x[d] for x in case], chunk=chunk)) for d in range(D)])
    got = list_rank.dominance_indexes(*tt, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    other = list_rank.dominance_indexes(*tt, chunk=48 if chunk == 16 else 16)
    assert not np.array_equal(other.numpy(), want)
