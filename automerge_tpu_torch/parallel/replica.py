"""Replica clock planning as torch ops.

The reference syncs peers with clock gossip: each connection unions the
clocks it hears (elementwise max) and ships every change the peer's
clock does not cover.  For R replicas of a doc, with their clocks as an
[R, A] matrix over the doc's actors:

  frontier  = max over replicas       -- the knowledge frontier
  deficit   = frontier - local clock  -- what each replica still needs
  at_frontier = local clock == frontier -- who can ship each stream

`batched_plan` computes all three for a whole DocSet, [D, R, A], in one
pass on the tensor's device.  `frontier_pmax` is the frontier across the
dp shards of a device grid (`parallel/mesh.make_mesh`), the JAX
package's `lax.pmax` over the dp axis.
"""

import torch


def clock_union(clocks_axis0):
    """Elementwise max of clocks stacked on axis 0."""
    return torch.amax(clocks_axis0, dim=0)


def frontier_pmax(local_clocks, mesh):
    """The elementwise max of the dp shards' [A] clocks (one tensor per
    shard, each on its shard's device), on the grid's first device.  The
    collective is explicit copies and one `amax`: a grid cell may repeat
    a device, which NCCL and `torch.cuda.comm` refuse."""
    first = mesh.devices[0][0]
    return torch.amax(torch.stack([c.to(first) for c in local_clocks]),
                      dim=0)


def replica_deficits(clocks):
    """Replica clocks [R, A] -> (frontier [A], deficit [R, A]), where
    deficit[r, a] counts the changes of actor a replica r lacks."""
    frontier = clock_union(clocks)
    return frontier, frontier[None, :] - clocks


def batched_plan(mats):
    """[D, R, A] clocks (docs x replicas x actors) -> (frontier [D, A],
    deficit [D, R, A], at_frontier [D, R, A] bool)."""
    frontier = torch.amax(mats, dim=1)
    deficit = frontier[:, None, :] - mats
    at_frontier = mats >= frontier[:, None, :]
    return frontier, deficit, at_frontier


def want_matrix(clocks, have_clock):
    """Which (replica, actor) streams a holder with clock `have_clock`
    [A] must ship to replicas with clocks [R, A]: ([R, A] bool, from_seq,
    to_seq), the shipping windows (from_seq, to_seq]."""
    from_seq = clocks
    to_seq = torch.broadcast_to(have_clock[None, :], clocks.shape)
    return to_seq > from_seq, from_seq, to_seq
