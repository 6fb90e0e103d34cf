"""The port's sharded resolver step against the JAX package's.

`automerge_tpu_torch.parallel.mesh.build_sharded_step` over a dp x sp
grid of CPU devices (the kernels' plain versions) must give every output
key of the JAX `build_sharded_step` over `tests/conftest.py`'s 8 virtual
CPU devices, on the same global batch: text, map and table workloads
(verified against the port engine's patches too) and `demo_batch`, at
(dp, sp) = (8, 1), (4, 2) and (2, 4).  The block mode of the plain
`dominance_indexes` is held to the JAX function in sequence-parallel
mode inside shard_map (the psum over sp of the blocks' counts), on the
random and chunk-dependent cases of `tests/torch_step_cases.py`, and the
blocks' sum to the whole-doc output.  Integer outputs: exact equality.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from automerge_tpu.ops import list_rank as JL
from automerge_tpu.parallel import mesh as JM
from automerge_tpu.parallel import mesh_encode as JE
from automerge_tpu.parallel import replica as JR
from automerge_tpu_torch import dryrun, trace
from automerge_tpu_torch.ops import dominance_kernel, list_rank
from automerge_tpu_torch.parallel import mesh as M
from automerge_tpu_torch.parallel import mesh_encode as E
from automerge_tpu_torch.parallel import replica
from tests.torch_step_cases import (SCAN_SHAPES, dominance_indexes_case,
                                    dominance_scan_case)
from torch_threads import cap_threads

cap_threads()

MESHES = ((8, 1), (4, 2), (2, 4))


def cpu_mesh(dp, sp):
    return M.make_mesh(dp, sp, devices=['cpu'] * (dp * sp))


def text(sp):
    return JE.demo_text_workload(n_docs=8 // sp * 2)


WORKLOADS = {
    'text': text,
    'map': lambda sp: JE.demo_map_workload(n_docs=8),
    'table': lambda sp: JE.demo_table_workload(n_docs=8),
}


def jax_sharded(dp, sp, batch, n_iters, chunk):
    mesh = JM.make_mesh(dp * sp, sp=sp)
    step = JM.build_sharded_step(mesh, n_linearize_iters=n_iters,
                                 chunk=chunk)
    return {k: np.asarray(v) for k, v in
            step(JM.shard_batch(mesh, batch)).items()}


def port_sharded(dp, sp, batch, n_iters, chunk):
    mesh = cpu_mesh(dp, sp)
    step = M.build_sharded_step(mesh, n_iters, chunk=chunk)
    return step(M.shard_batch(mesh, batch))


def assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        assert g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize('dp,sp', MESHES)
@pytest.mark.parametrize('name', sorted(WORKLOADS))
def test_sharded_step_matches_jax(name, dp, sp):
    workload = WORKLOADS[name](sp)
    batch, meta = E.encode_batch(workload, sp=sp)
    n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
    got = port_sharded(dp, sp, batch, n_iters, chunk=16)
    assert_outputs_equal(got, jax_sharded(dp, sp, batch, n_iters, 16))
    E.verify_against_pool(workload, meta, got, device='cpu')


@pytest.mark.parametrize('dp,sp', MESHES)
def test_sharded_step_demo_batch_matches_jax_and_single(dp, sp):
    batch = M.demo_batch(n_docs=2 * dp, n_elems=8 * sp, n_list_ops=12)
    n_iters = list_rank.ceil_log2(batch['eo'].shape[1]) + 1
    got = port_sharded(dp, sp, batch, n_iters, chunk=4)
    assert_outputs_equal(got, jax_sharded(dp, sp, batch, n_iters, 4))
    single = M.single_step(batch, n_iters, device='cpu')
    for k in single:
        np.testing.assert_array_equal(got[k].numpy(), single[k].numpy(),
                                      err_msg=k)


def test_sharded_step_counts_its_spans_and_checks_shapes():
    batch = M.demo_batch(n_docs=4, n_elems=16)
    mesh = cpu_mesh(2, 2)
    step = M.build_sharded_step(mesh, 5)
    trace.reset()
    step(M.shard_batch(mesh, batch))
    spans = trace.snapshot()['spans']
    for name in ('step.gather', 'step.schedule', 'step.registers',
                 'step.linearize', 'step.op_metadata', 'step.route'):
        assert name in spans, name
    with pytest.raises(ValueError, match='divide'):
        M.shard_batch(cpu_mesh(3, 1), batch)
    with pytest.raises(ValueError, match='divide'):
        M.shard_batch(cpu_mesh(1, 3), batch)
    with pytest.raises(ValueError, match='sharded over'):
        step(M.shard_batch(cpu_mesh(4, 1), batch))


def test_make_mesh_places_cells_row_by_row():
    mesh = M.make_mesh(2, 2, devices=['cpu'])
    assert mesh.shape == {'dp': 2, 'sp': 2}
    assert all(d == torch.device('cpu') for row in mesh.devices
               for d in row)
    with pytest.raises(ValueError):
        M.make_mesh(0, 1, devices=['cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='make_mesh.*CUDA'):
            M.make_mesh(2, 1)


# -- the block mode of dominance_indexes ------------------------------------

def jax_sp_indexes(case, sp, chunk):
    """The JAX function in sequence-parallel mode: each of `sp` virtual
    devices holds one block of every doc's elements, the psum over sp
    completes the counts."""
    eo, er, vis, oe, oo, orr, od, ov = case
    L = eo.shape[1]
    Ll = L // sp
    mesh = JaxMesh(np.array(jax.devices()[:sp]), ('sp',))

    def body(eo, er, vis, oe, oo, orr, od, ov):
        off = jax.lax.axis_index('sp') * Ll
        return jax.vmap(lambda *a: JL.dominance_indexes(
            *a, chunk=chunk, axis_name='sp', l_offset=off))(
            eo, er, vis, oe, oo, orr, od, ov)

    blk, rep = P(None, 'sp'), P()
    fn = JM.shard_map(body, mesh, in_specs=(blk, blk, blk) + (rep,) * 5,
                      out_specs=rep)
    return np.asarray(jax.jit(fn)(eo, er, vis, oe, oo, orr, od, ov))


def port_blocks(case, sp, chunk):
    eo, er, vis, oe, oo, orr, od, ov = [torch.from_numpy(x) for x in case]
    Ll = eo.shape[1] // sp
    blocks = [slice(s * Ll, (s + 1) * Ll) for s in range(sp)]
    return [dominance_kernel.dominance_indexes_block_auto(
        eo[:, b], er[:, b], vis[:, b], oe, oo, orr, od, ov, chunk=chunk,
        l_offset=b.start).numpy() for b in blocks]


SP_CASES = [('random', dominance_indexes_case, s)
            for s in ((3, 40, 100, 3), (2, 300, 700, 5), (4, 16, 5, 1))] + \
    [('chunk-dependent', dominance_scan_case, s) for s in SCAN_SHAPES]


@pytest.mark.parametrize('sp', [2, 4])
@pytest.mark.parametrize('kind,make,shape', SP_CASES,
                         ids=['%s-%s' % (k, 'x'.join(map(str, s)))
                              for k, _m, s in SP_CASES])
def test_block_mode_matches_jax_sp_mode(kind, make, shape, sp):
    D, L, T, n_obj = shape
    L = (L + sp - 1) // sp * sp
    case = make(np.random.RandomState(sum(shape) + sp), D, L, T, n_obj)
    for chunk in (16, 64):
        parts = port_blocks(case, sp, chunk)
        total = np.sum(parts, axis=0, dtype=np.int32)
        np.testing.assert_array_equal(total, jax_sp_indexes(case, sp, chunk))
        whole = list_rank.dominance_indexes(
            *[torch.from_numpy(x) for x in case], chunk=chunk).numpy()
        np.testing.assert_array_equal(total, whole)
    # one block at l_offset 0 is the whole-doc function
    np.testing.assert_array_equal(
        port_blocks(case, 1, 16)[0],
        list_rank.dominance_indexes(*[torch.from_numpy(x) for x in case],
                                    chunk=16).numpy())


def test_block_wrapper_refuses_cpu_tensors_and_wide_counts():
    case = [torch.from_numpy(x) for x in dominance_indexes_case(
        np.random.RandomState(3), 2, 8, 8, 1)]
    with pytest.raises(ValueError, match='CUDA'):
        dominance_kernel.dominance_indexes_block_cuda(*case)
    with pytest.raises(ValueError, match='CUDA'):
        dominance_kernel.dominance_indexes_block_cuda(*[x[0] for x in case])
    with pytest.raises(ValueError, match='2\\^24'):
        dominance_kernel.block_count_bound(1 << 23, 1 << 23, 64)
    with pytest.raises(ValueError, match='block-mode'):
        list_rank.dominance_indexes(*case, l_offset=4)


# -- the frontier over dp shards, and the dryrun ----------------------------

def test_frontier_pmax_matches_jax():
    rs = np.random.RandomState(5)
    clocks = rs.randint(0, 50, (4, 6)).astype(np.int32)
    mesh = JaxMesh(np.array(jax.devices()[:4]), ('dp',))
    fn = JM.shard_map(lambda c: JR.frontier_pmax(c[0], 'dp')[None], mesh,
                      in_specs=(P('dp'),), out_specs=P('dp'))
    want = np.asarray(jax.jit(fn)(clocks))[0]
    got = replica.frontier_pmax([torch.from_numpy(c) for c in clocks],
                                cpu_mesh(4, 1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dryrun_multichip_on_cpu_devices(capsys):
    fn, args = dryrun.entry(device='cpu')
    out = fn(*args)
    assert 'indexes' in out and 'frontier' in out
    table = dryrun.dryrun_multichip(4, devices=['cpu'] * 4,
                                    scaling_docs=128)
    assert [(r['dp'], r['sp']) for r in table] == [(1, 1), (2, 1), (4, 1),
                                                   (2, 2)]
    assert all(r['median_s'] > 0 for r in table)
    assert 'scaling workload: 128 docs' in capsys.readouterr().out
