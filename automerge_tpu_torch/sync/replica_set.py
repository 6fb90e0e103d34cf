"""Batched replica catch-up over the port's pools.

The reference's connection protocol (clock gossip, then ship every change
the peer's clock does not cover) run at pool granularity: every doc of
every replica pair exchanges in one planned round, and the shipped
changes apply as one batch per receiver.  Planning is one
`parallel.replica.batched_plan` over the whole DocSet's [D, R, A] clock
stack on the replicas' device; shipping moves raw change bytes between
pools on the host (`get_changes_for_actor_bytes`), and the receivers'
batches apply with host/device overlap across pools
(`native.apply_payloads_pipelined`).  Duplicate deliveries are no-ops
(seq dedup) and causal gaps wait in the receiver's queue, so a dropped
shipment heals on a later round.
"""

import msgpack
import numpy as np
import torch

from ..native import NativeDocPool, apply_payloads_pipelined
from ..parallel.replica import batched_plan
from ..utils import ROOT_ID, array_header, doc_key, map_header
from ..utils import read_array_header


class BatchedReplicaSet:
    """N pool-backed replicas with planned all-pairs catch-up.

    `pool_factory` builds one pool per replica (a CUDA `NativeDocPool` by
    default).  `drop(sender, receiver, doc_id) -> bool` is an optional
    fault hook: True drops that shipment for the round (it is planned
    again on the next).  Planning runs on `device` (default: the first
    replica's device)."""

    def __init__(self, n_replicas, pool_factory=None, drop=None,
                 device=None):
        if pool_factory is None:
            pool_factory = NativeDocPool
        self.replicas = [pool_factory() for _ in range(n_replicas)]
        self.device = torch.device(
            device if device is not None
            else getattr(self.replicas[0], 'device', 'cpu'))
        self.doc_ids = []
        self._doc_set = set()
        self._drop = drop

    # -- local ingestion ------------------------------------------------

    def _note_doc(self, doc_id):
        if doc_id not in self._doc_set:
            self._doc_set.add(doc_id)
            self.doc_ids.append(doc_id)

    def apply_changes(self, replica, doc_id, changes):
        """Applies changes at one replica."""
        self._note_doc(doc_id)
        return self.replicas[replica].apply_changes(doc_id, changes)

    def apply_batch(self, replica, changes_by_doc):
        for doc_id in changes_by_doc:
            self._note_doc(doc_id)
        return self.replicas[replica].apply_batch(changes_by_doc)

    # -- planned catch-up ----------------------------------------------

    def _clock_matrix(self, doc_id):
        """Dense [R, A] clock matrix and the actor table of one doc."""
        clocks = [r.get_clock(doc_id)['clock'] for r in self.replicas]
        actors = sorted({a for c in clocks for a in c})
        idx = {a: i for i, a in enumerate(actors)}
        mat = np.zeros((len(self.replicas), max(len(actors), 1)), np.int32)
        for r, c in enumerate(clocks):
            for a, s in c.items():
                mat[r, idx[a]] = s
        return mat, actors

    def plan_all(self):
        """Every doc's shipments from one planning pass:
        {doc_id: [(sender, receiver, actor, after_seq)]}.  Docs and
        actors pad to powers of two, as the JAX set pads them."""
        if not self.doc_ids:
            return {}
        per_doc = [self._clock_matrix(d) for d in self.doc_ids]
        A = 1
        while A < max(m.shape[1] for m, _ in per_doc):
            A *= 2
        D = 1
        while D < len(per_doc):
            D *= 2
        mats = np.zeros((D, len(self.replicas), A), np.int32)
        for i, (m, _) in enumerate(per_doc):
            mats[i, :, :m.shape[1]] = m
        _frontier, deficit, at_frontier = (
            t.cpu().numpy() for t in batched_plan(
                torch.from_numpy(mats).to(self.device)))
        plans = {}
        for i, doc_id in enumerate(self.doc_ids):
            if not deficit[i].any():
                continue
            # the first replica at the frontier ships each stream (numpy's
            # argmax of a bool column: the first True)
            holder = np.argmax(at_frontier[i], axis=0)
            mat, actors = per_doc[i]
            ships = []
            recvs, acts = np.nonzero(deficit[i] > 0)
            for r, a in zip(recvs.tolist(), acts.tolist()):
                if a < len(actors):
                    ships.append((int(holder[a]), int(r), actors[a],
                                  int(mat[r, a])))
            if ships:
                plans[doc_id] = ships
        return plans

    def catch_up(self, max_rounds=None):
        """Gossip rounds until no replica lacks a change on any doc.
        Returns the changes shipped per round."""
        if max_rounds is None:
            # R rounds suffice for a connected exchange, plus slack for
            # dropped shipments
            max_rounds = 4 * len(self.replicas) + 8
        rounds = []
        for _ in range(max_rounds):
            planned, shipped = self._one_round()
            rounds.append(shipped)
            # ends on PLANNED work: a round whose shipments all dropped
            # is planned again
            if planned == 0:
                return rounds
        raise RuntimeError(
            'replica catch-up did not converge in %d rounds' % max_rounds)

    def _one_round(self):
        """One planning pass, then one batch per receiver: the shipped
        raw arrays spliced into one {doc: [change, ...]} payload (count
        headers summed, bodies concatenated), applied pipelined across
        the receivers' pools."""
        planned = shipped = 0
        inbox = {}   # receiver -> {doc_id: [(count, body view)]}
        for doc_id, ships in self.plan_all().items():
            planned += len(ships)
            for s, r, actor, after_seq in ships:
                if self._drop is not None and self._drop(s, r, doc_id):
                    continue
                buf = self.replicas[s].get_changes_for_actor_bytes(
                    doc_id, actor, after_seq)
                n, off = read_array_header(buf)
                if n == 0:
                    continue
                shipped += n
                inbox.setdefault(r, {}).setdefault(doc_id, []).append(
                    (n, memoryview(buf)[off:]))
        deliveries = []
        for r, by_doc in inbox.items():
            parts = [map_header(len(by_doc))]
            for doc_id, arrays in by_doc.items():
                parts.append(msgpack.packb(doc_key(doc_id),
                                           use_bin_type=True))
                parts.append(array_header(sum(n for n, _ in arrays)))
                parts.extend(body for _, body in arrays)
            deliveries.append((self.replicas[r], b''.join(parts)))
        if deliveries and all(isinstance(p, NativeDocPool)
                              for p, _ in deliveries):
            apply_payloads_pipelined(deliveries)
        else:
            for pool, payload in deliveries:
                pool.apply_batch_bytes(payload)
        return planned, shipped

    # -- verification ---------------------------------------------------

    def converged(self):
        """True when all replicas report the same clock on every doc."""
        for doc_id in self.doc_ids:
            clocks = [r.get_clock(doc_id)['clock'] for r in self.replicas]
            if any(c != clocks[0] for c in clocks[1:]):
                return False
        return True

    def assert_identical(self, doc_id):
        """All replicas hold the same document state (trees and clocks;
        whole-doc patches list map fields in each replica's own key
        order).  Returns replica 0's patch."""
        patches = [r.get_patch(doc_id) for r in self.replicas]
        t0 = patch_to_tree(patches[0])
        for i, p in enumerate(patches[1:], 1):
            if p['clock'] != patches[0]['clock'] or patch_to_tree(p) != t0:
                raise AssertionError(
                    'replica %d diverged on %r' % (i, doc_id))
        return patches[0]


def patch_to_tree(patch):
    """A whole-doc patch as a nested comparable tree (maps -> sorted
    tuples, lists and text -> tuples, conflicts kept per slot).  Two
    replicas converged iff their trees and clocks are equal."""
    objs = {ROOT_ID: {}}
    types = {ROOT_ID: 'map'}

    def slot(d):
        v = ('link', d['value']) if d.get('link') else ('val', d.get('value'),
                                                        d.get('datatype'))
        conflicts = tuple(
            (c.get('actor'),
             ('link', c['value']) if c.get('link') else ('val',
                                                         c.get('value')))
            for c in d.get('conflicts', ()))
        return (v, conflicts)

    for d in patch['diffs']:
        obj = d['obj']
        action = d['action']
        if action == 'create':
            objs[obj] = [] if d['type'] in ('list', 'text') else {}
            types[obj] = d['type']
        elif action == 'set':
            objs.setdefault(obj, {})[d['key']] = slot(d)
        elif action == 'insert':
            objs.setdefault(obj, []).insert(d['index'], slot(d))
        elif action == 'remove':
            if 'index' in d:
                objs[obj].pop(d['index'])
            else:
                objs[obj].pop(d['key'], None)

    def resolve(ref, seen):
        if ref[0] == 'val':
            return ref
        target = ref[1]
        if target in seen:
            return ('cycle', target)
        return ('obj', types.get(target),
                resolve_obj(target, seen | {target}))

    def resolve_obj(obj, seen):
        v = objs.get(obj)
        if isinstance(v, dict):
            return tuple(sorted(
                (k, resolve(s[0], seen),
                 tuple((a, resolve(rv, seen)) for a, rv in s[1]))
                for k, s in v.items()))
        return tuple((resolve(s[0], seen),
                      tuple((a, resolve(rv, seen)) for a, rv in s[1]))
                     for s in v)

    return resolve_obj(ROOT_ID, {ROOT_ID})
