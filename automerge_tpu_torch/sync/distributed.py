"""Replica sync across processes: the connection protocol between
processes that each host some of the replicas.

The reference syncs peers with messages of ``{docId, clock, changes}``.
Here the two halves of that protocol take two transports:

* **Clock gossip (dense numbers)** is a `torch.distributed` all-gather
  over the gloo backend, on CPU tensors: every process contributes its
  replicas' ``[R_local, D * A]`` clock matrix and gets the global one.
  Planning then runs the same function (`parallel.replica.batched_plan`)
  in every process: the same inputs give the same plan with no further
  coordination.
* **Change shipping (sparse bytes)** crosses a TCP mesh between the
  processes (`ProcessMesh`): each planned shipment whose sender is local
  pulls raw change bytes from the sender's pool and sends one
  ``{docId, clock, changes}`` message (msgpack behind a 4-byte length
  prefix) to the process that hosts the receiver.

Faults heal as in the single-process `BatchedReplicaSet`: a duplicate
delivery is a seq-deduplicated no-op and a causal gap waits in the
receiver's queue until a later round.

Run: ``python -m automerge_tpu_torch.sync.distributed --processes 2
[--device cuda|cpu]`` spawns the workers (their pools on the card unless
``--device cpu``; every worker on one card shares it), seeds disjoint
per-replica streams, runs the catch-up and checks every replica of every
process against the port's scalar oracle.  Gloo, not NCCL, carries the
gossip: NCCL refuses two ranks on one GPU.
"""

import json
import os
import socket
import struct
import sys
import threading
import time

import msgpack
import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: seconds a process keeps retrying a peer's listener
CONNECT_DEADLINE_S = 60.0


# ---------------------------------------------------------------------------
# collectives (gloo, CPU tensors)
# ---------------------------------------------------------------------------

def allgather_blob(data):
    """Every process's bytes blob, in process order: the lengths first,
    then the blobs padded to the longest (a collective's tensors have one
    shape)."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64))
    width = max(max(int(x) for x in lens), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8)
    got = [torch.zeros(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(got, buf)
    return [g[:int(m)].numpy().tobytes() for g, m in zip(got, lens)]


def allgather_clock_mats(local_mat):
    """The global ``[R, A]`` clock matrix from every process's
    ``[R_local, A]`` one (replicas in process order): one all-gather."""
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(local_mat, np.int32))
    got = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    return torch.cat(got).numpy().reshape(-1, local_mat.shape[1])


# ---------------------------------------------------------------------------
# TCP mesh (change shipping)
# ---------------------------------------------------------------------------

class ProcessMesh:
    """A small synchronous P-process TCP mesh.  Each process listens on
    ``port_base + pid``; a sender's connection opens at its first message
    and stays open.  A message is msgpack bytes behind a 4-byte
    big-endian length (the sidecar's msgpack framing)."""

    def __init__(self, pid, n_processes, port_base,
                 connect_deadline_s=CONNECT_DEADLINE_S):
        self.pid = pid
        self.n = n_processes
        self.port_base = port_base
        self.connect_deadline_s = connect_deadline_s
        self.server = socket.create_server(('127.0.0.1', port_base + pid),
                                           backlog=n_processes)
        self.out = {}
        self.inbox = {}   # peer pid -> accepted socket

    def _connect(self, peer):
        sock = self.out.get(peer)
        if sock is None:
            # a peer that starts slowly (its CUDA context, its kernels)
            # is retried with a capped backoff until the deadline
            deadline = time.time() + self.connect_deadline_s
            delay, timeout = 0.05, 1.0
            while True:
                try:
                    sock = socket.create_connection(
                        ('127.0.0.1', self.port_base + peer),
                        timeout=min(timeout, max(0.1,
                                                 deadline - time.time())))
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(min(delay, max(0.0,
                                              deadline - time.time())))
                    delay = min(delay * 1.6, 2.0)
                    timeout = min(timeout * 2, 5.0)
            sock.settimeout(None)
            sock.sendall(struct.pack('>I', self.pid))
            self.out[peer] = sock
        return sock

    def _accept_from(self, peer):
        # a peer that died before connecting fails here, not forever
        self.server.settimeout(60)
        while peer not in self.inbox:
            try:
                conn, _ = self.server.accept()
            except socket.timeout:
                raise ConnectionError(
                    'peer %d never connected (crashed?)' % peer)
            conn.settimeout(None)
            hdr = self._read_exact(conn, 4)
            self.inbox[struct.unpack('>I', hdr)[0]] = conn
        return self.inbox[peer]

    @staticmethod
    def _read_exact(sock, n):
        parts = []
        while n:
            chunk = sock.recv(n)
            if not chunk:
                raise ConnectionError('peer closed')
            parts.append(chunk)
            n -= len(chunk)
        return b''.join(parts)

    def send(self, peer, payload):
        sock = self._connect(peer)
        sock.sendall(struct.pack('>I', len(payload)) + payload)

    def recv(self, peer):
        sock = self._accept_from(peer)
        n = struct.unpack('>I', self._read_exact(sock, 4))[0]
        return self._read_exact(sock, n)

    def close(self):
        for sock in self.out.values():
            sock.close()
        for sock in self.inbox.values():
            sock.close()
        self.server.close()


# ---------------------------------------------------------------------------
# the distributed replica set
# ---------------------------------------------------------------------------

class DistributedReplicaSet:
    """``n_local`` pool-backed replicas in this process, kept in sync with
    the other processes' replicas (the process group must be up).  Global
    replica r lives in process ``r // n_local`` (every process hosts the
    same count).  `pool_factory` builds each pool: a `NativeDocPool` on
    `device` by default (the card unless 'cpu')."""

    def __init__(self, pid, n_processes, n_local, port_base,
                 pool_factory=None, device=None):
        if pool_factory is None:
            from ..native import NativeDocPool

            def pool_factory():
                return NativeDocPool(device)
        self.pid = pid
        self.n_processes = n_processes
        self.n_local = n_local
        self.replicas = [pool_factory() for _ in range(n_local)]
        self.mesh = ProcessMesh(pid, n_processes, port_base)
        self.doc_ids = []
        self._doc_set = set()

    # -- local ingestion ------------------------------------------------

    def apply_batch(self, local_replica, changes_by_doc):
        for doc_id in changes_by_doc:
            if doc_id not in self._doc_set:
                self._doc_set.add(doc_id)
                self.doc_ids.append(doc_id)
        return self.replicas[local_replica].apply_batch(changes_by_doc)

    # -- one gossip round ----------------------------------------------

    def _exchange_metadata(self):
        """Doc ids and each doc's actors, agreed by every process before
        the numeric all-gather (one blob all-gather)."""
        local = {
            'docs': sorted(self._doc_set),
            'actors': {d: sorted(
                {a for r in self.replicas
                 for a in r.get_clock(d)['clock']})
                for d in self._doc_set},
        }
        blobs = allgather_blob(json.dumps(local).encode())
        docs = sorted({d for b in blobs for d in json.loads(b)['docs']})
        actors = {}
        for b in blobs:
            for d, acts in json.loads(b)['actors'].items():
                actors.setdefault(d, set()).update(acts)
        return docs, {d: sorted(a) for d, a in actors.items()}

    def _one_round(self):
        import torch

        from ..parallel.replica import batched_plan
        from ..utils import (array_header, doc_key, map_header,
                             read_array_header)

        docs, actors_by_doc = self._exchange_metadata()
        if not docs:
            return 0
        A = 1
        while A < max(max((len(a) for a in actors_by_doc.values()),
                          default=1), 1):
            A *= 2
        D = 1
        while D < len(docs):
            D *= 2

        # local [D, R_local, A] clocks -> global [D, R, A] by one
        # all-gather (flattened to one fixed shape)
        local = np.zeros((D, self.n_local, A), np.int32)
        for i, d in enumerate(docs):
            idx = {a: j for j, a in enumerate(actors_by_doc[d])}
            for rl, pool in enumerate(self.replicas):
                for a, s in pool.get_clock(d)['clock'].items():
                    local[i, rl, idx[a]] = s
        gathered = allgather_clock_mats(
            local.transpose(1, 0, 2).reshape(self.n_local, D * A))
        R = gathered.shape[0]
        mats = np.ascontiguousarray(
            gathered.reshape(R, D, A).transpose(1, 0, 2))

        # the same plan in every process
        frontier, deficit, at_frontier = (
            x.numpy() for x in batched_plan(torch.from_numpy(mats)))
        planned_total = 0
        # outbox[peer pid] -> messages {docId, clock, changes}
        outbox = {p: [] for p in range(self.n_processes)}

        for i, doc_id in enumerate(docs):
            if not deficit[i].any():
                continue
            acts = actors_by_doc[doc_id]
            holder = np.argmax(at_frontier[i], axis=0)
            recvs, streams = np.nonzero(deficit[i] > 0)
            ships = {}   # (sender, receiver) -> [(actor, after_seq)]
            for r, a in zip(recvs.tolist(), streams.tolist()):
                if a >= len(acts):
                    continue
                s = int(holder[a])
                ships.setdefault((s, r), []).append(
                    (acts[a], int(mats[i, r, a])))
            for (s, r), streams_list in ships.items():
                planned_total += len(streams_list)
                sp, rp = s // self.n_local, r // self.n_local
                if sp != self.pid:
                    continue
                # the sender is local: one message in the reference's
                # schema, its changes spliced as raw bytes
                sender_pool = self.replicas[s % self.n_local]
                arrays = []
                total = 0
                for actor, after_seq in streams_list:
                    buf = sender_pool.get_changes_for_actor_bytes(
                        doc_id, actor, after_seq)
                    cnt, off = read_array_header(buf)
                    if cnt:
                        arrays.append(memoryview(buf)[off:])
                        total += cnt
                if not total:
                    continue
                clock = sender_pool.get_clock(doc_id)['clock']
                msg = [msgpack.packb({'to': r, 'docId': doc_key(doc_id)},
                                     use_bin_type=True),
                       msgpack.packb(clock, use_bin_type=True),
                       array_header(total)] + arrays
                outbox[rp].append(b''.join(msg))

        # a synchronous round: every process sends exactly one batch
        # message (maybe empty) to every other.  Sends run on threads, so
        # that processes blocked in sendall cannot wedge one another
        # before their receive loops start
        errors = []

        def ship(peer):
            try:
                batch = msgpack.packb(len(outbox[peer]), use_bin_type=True)
                self.mesh.send(peer, batch + b''.join(
                    msgpack.packb(m, use_bin_type=True)
                    for m in outbox[peer]))
            except Exception as e:        # raised after the join
                errors.append((peer, e))

        senders = [threading.Thread(target=ship, args=(peer,))
                   for peer in range(self.n_processes) if peer != self.pid]
        for t in senders:
            t.start()

        inbound = list(outbox[self.pid])
        for peer in range(self.n_processes):
            if peer == self.pid:
                continue
            unp = msgpack.Unpacker(raw=False)
            unp.feed(self.mesh.recv(peer))
            for _ in range(unp.unpack()):
                inbound.append(unp.unpack())
        for t in senders:
            t.join()
        if errors:
            raise ConnectionError('send to peer %d failed: %s' % errors[0])

        # delivery: one apply_batch_bytes per local receiver
        per_receiver = {}
        for m in inbound:
            unp = msgpack.Unpacker(raw=True)
            unp.feed(m)
            head = unp.unpack()
            r = head[b'to']
            key = head[b'docId']
            body = m[unp.tell():]
            per_receiver.setdefault(int(r), {}).setdefault(
                key if isinstance(key, str) else key.decode(),
                []).append(body)

        for r, by_doc in per_receiver.items():
            pool = self.replicas[r % self.n_local]
            parts = [map_header(len(by_doc))]
            for doc_id, messages in by_doc.items():
                parts.append(msgpack.packb(doc_key(doc_id),
                                           use_bin_type=True))
                # each body is the sender's clock and an array of
                # changes: re-framed as one array of every change; a
                # message whose advertised clock the receiver's already
                # covers is skipped whole
                try:
                    own = pool.get_clock(doc_id)['clock']
                except Exception:
                    own = {}             # the receiver has no state yet
                bodies = []
                total = 0
                for body in messages:
                    unp = msgpack.Unpacker(raw=False)
                    unp.feed(body)
                    advertised = unp.unpack()
                    off = unp.tell()
                    if advertised and own and all(
                            own.get(a, 0) >= s
                            for a, s in advertised.items()):
                        continue
                    cnt, hoff = read_array_header(body[off:])
                    total += cnt
                    bodies.append(body[off + hoff:])
                parts.append(array_header(total))
                parts.extend(bodies)
            pool.apply_batch_bytes(b''.join(parts))
        return planned_total

    def catch_up(self, max_rounds=None):
        """Gossip rounds until one plans nothing; returns each round's
        planned stream count (the last is 0)."""
        if max_rounds is None:
            max_rounds = 4 * self.n_processes * self.n_local + 8
        rounds = []
        for _ in range(max_rounds):
            planned = self._one_round()
            rounds.append(planned)
            if planned == 0:
                return rounds
        raise RuntimeError('distributed catch-up did not converge in %d '
                           'rounds' % max_rounds)

    # -- verification ---------------------------------------------------

    def global_trees(self):
        """Every replica's materialized tree per doc, all-gathered: each
        process returns the same [process][doc] -> [tree per replica]."""
        from .replica_set import patch_to_tree
        local = {
            str(d): [repr(patch_to_tree(r.get_patch(d)))
                     for r in self.replicas]
            for d in self.doc_ids}
        blobs = allgather_blob(json.dumps(local).encode())
        return [json.loads(b) for b in blobs]

    def close(self):
        self.mesh.close()


# ---------------------------------------------------------------------------
# the dryrun: workers and their launcher
# ---------------------------------------------------------------------------

#: replicas each worker hosts
N_LOCAL = 2
#: docs each replica writes to
N_DOCS = 2


def streams(n_processes, n_local=N_LOCAL):
    """The dryrun's changes: {doc id: [(global replica, [change, ...])]},
    global replica r authoring actor 'a<r>' (three changes of one set
    each) on every doc.  Disjoint streams, so the catch-up must ship
    every replica's changes to every other."""
    from ..utils import ROOT_ID
    out = {}
    for d in range(N_DOCS):
        per = []
        for g in range(n_processes * n_local):
            actor = 'a%02d' % g
            per.append((g, [{'actor': actor, 'seq': s, 'deps': {},
                             'ops': [{'action': 'set', 'obj': ROOT_ID,
                                      'key': 'k%d' % ((s + g) % 5),
                                      'value': '%s-%d' % (actor, s)}]}
                            for s in range(1, 4)]))
        out['doc-%d' % d] = per
    return out


def _worker(pid, n_processes, store_port, mesh_port_base, device):
    import datetime

    import torch.distributed as dist

    from .. import backend as oracle
    from .replica_set import patch_to_tree

    dist.init_process_group(
        'gloo', init_method='tcp://127.0.0.1:%d' % store_port,
        world_size=n_processes, rank=pid,
        timeout=datetime.timedelta(seconds=120))
    try:
        rs = DistributedReplicaSet(pid, n_processes, N_LOCAL,
                                   mesh_port_base, device=device)
        union = {}
        for doc, per in streams(n_processes).items():
            union[doc] = [c for _g, chs in per for c in chs]
            for g, chs in per:
                if g // N_LOCAL == pid:
                    rs.apply_batch(g % N_LOCAL, {doc: chs})
        t0 = time.perf_counter()
        rounds = rs.catch_up()
        wall = time.perf_counter() - t0

        # every replica of every process equals the oracle's union
        want = {}
        for doc, chs in union.items():
            st, _ = oracle.apply_changes(oracle.init(), chs)
            want[doc] = repr(patch_to_tree(oracle.get_patch(st)))
        trees = rs.global_trees()
        for proc_trees in trees:
            for doc in union:
                for tree in proc_trees[doc]:
                    assert tree == want[doc], \
                        'divergence at pid %d on %s' % (pid, doc)
        rs.close()
    finally:
        dist.destroy_process_group()
    print('DISTRIBUTED-TREES pid=%d %s' % (pid, json.dumps(trees)),
          flush=True)
    print('DISTRIBUTED-OK pid=%d rounds=%s wall=%.6f'
          % (pid, rounds, wall), flush=True)


#: output texts of transport flakes that a retry absorbs, the JAX
#: module's list: a worker aborted by a transport race takes the others
#: down with teardown errors (peer reset, broken pipe), and a retry may
#: meet a port the kernel still holds in TIME_WAIT.  Not bare status
#: words, which real failures print too
_FLAKY_SIGNATURES = ('op.preamble.length', 'heartbeat timeout',
                     'Shutdown barrier', 'coordination service',
                     'Connection reset by peer', 'Broken pipe',
                     'Address already in use')


def _free_port():
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        return probe.getsockname()[1]


def launch(n_processes=2, timeout=300, device=None, _retries=3):
    """Spawns the dryrun's workers (pools on the card unless `device` is
    'cpu') and returns their outputs; raises on a worker's non-zero exit.
    The C++ core and the kernels build here first, so the workers find
    them built.  Bounded retries absorb the transport flakes of
    `_FLAKY_SIGNATURES`, looked for in every worker's output."""
    import subprocess

    from ..native import _lib, _pool_device
    device = _pool_device(device, 'launch')
    _lib.build()
    if device.type == 'cuda':
        from ..ops import _build
        _build.build_all()
    store_port = _free_port()
    mesh_port_base = store_port + 1000 if store_port < 64000 else 21000
    procs = [
        subprocess.Popen(
            [sys.executable, '-m', 'automerge_tpu_torch.sync.distributed',
             '--worker', str(pid), '--processes', str(n_processes),
             '--store-port', str(store_port),
             '--mesh-port-base', str(mesh_port_base),
             '--device', device.type],
            cwd=REPO_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(n_processes)]
    outs = []
    failed = None
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                try:
                    o, _ = q.communicate(timeout=10)
                except Exception:
                    o = ''
                outs.append(o or '')
            # a mesh with one dead worker hangs the rest at a collective:
            # retry that shape only (a worker that exited by itself, or a
            # flake text); a mesh where every worker hangs is a deadlock
            died_alone = any(q.returncode not in (0, -9) for q in procs)
            flaky = any(sig in o for o in outs
                        for sig in _FLAKY_SIGNATURES)
            if _retries > 0 and (died_alone or flaky):
                return launch(n_processes, timeout, device, _retries - 1)
            raise
        outs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (p.returncode, out)
    if failed is not None:
        rc, out = failed
        if _retries > 0 and any(sig in o for o in outs
                                for sig in _FLAKY_SIGNATURES):
            return launch(n_processes, timeout, device, _retries - 1)
        raise RuntimeError('worker failed (rc=%d):\n%s' % (rc, out))
    return outs


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--processes', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--worker', type=int, default=None)
    ap.add_argument('--store-port', type=int, default=None)
    ap.add_argument('--mesh-port-base', type=int, default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker, args.processes, args.store_port,
                args.mesh_port_base, args.device)
        return 0
    for out in launch(args.processes, device=args.device):
        sys.stdout.write(out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
