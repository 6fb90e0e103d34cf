"""Fleet replica supervisor.

The self-healing sidecar pattern lifted to fleet scope: the
router spawns its replica server subprocesses, watches them, and
brings killed ones back -- while the health monitor + failover
executor keep the doc space serveable in between.

Lifecycle of one supervised member::

    spawn('r1')  ->  member 'r1'   (gen 0, socket + durable store
                                    provisioned under base_dir)
    SIGKILL      ->  monitor sees the exit -> health.mark_dead('r1')
                     -> failover drains r1's docs to survivors
    respawn      ->  member 'r1-g1' joins the ring as a NEW member
                     (capped-backoff, waits for the failover to
                     finish removing the old id first); the
                     Rebalancer's normal skew trigger then drains
                     docs back onto the empty rejoiner

A member id never rejoins under its old name: the ring treats
generations as distinct members, so stale WrongReplica owners and the
placement journal stay unambiguous.  A lineage that keeps dying
(``FLEET_FLAP_MAX`` deaths) is quarantined -- no further
respawns, the health entry renders ``quarantined`` -- because a
crash-looping replica re-absorbing its docs just loses them again.

Each spawned replica is the port's server
(``python -m automerge_tpu_torch.sidecar.server``) on ``device`` (the
card by default), named by ``--replica-id <member>``, with its own
durable store (``--storage-dir <base_dir>/store-<member> --durable``)
and write-through checkpointing (``--sync``), so an ack always implies
a restorable blob -- the property failover's byte parity rests on.  A
replica that does not come up on its device is an error: the
supervisor never moves it to another device.
"""

import os
import sys
import threading
import time

from .. import telemetry
from ..tools import proc as P

#: deaths of one lineage before it is quarantined (the JAX package's
#: AMTPU_FLEET_FLAP_MAX)
FLEET_FLAP_MAX = 3


class ReplicaSupervisor(object):
    """Spawns, watches, and respawns replica server subprocesses.

    ``health`` / ``failover`` are the detection + recovery hooks;
    without them the supervisor still respawns (standalone
    supervision), but nothing re-places docs in the gap.  ``device``
    is every replica's ``--device`` ('cuda' or 'cpu').
    """

    def __init__(self, router, base_dir, health=None, failover=None,
                 flap_max=None, spawn_deadline_s=60.0, device='cuda'):
        self.router = router
        self.base_dir = base_dir
        self.health = health
        self.failover = failover
        self.flap_max = max(1, flap_max if flap_max is not None
                            else FLEET_FLAP_MAX)
        self.device = device
        self.spawn_deadline_s = spawn_deadline_s
        self._lock = threading.Lock()
        self._procs = {}     # {member: Popen}    guarded-by: self._lock
        self._lineage = {}   # {base: deaths}     guarded-by: self._lock
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run,
                                        name='amtpu-fleet-supervisor',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            procs = dict(self._procs)
            self._procs.clear()
        P.stop_all(procs)

    # -- spawning -------------------------------------------------------

    @staticmethod
    def _member_name(base, gen):
        return base if gen == 0 else '%s-g%d' % (base, gen)

    @staticmethod
    def _parse(member):
        base, sep, gen = member.rpartition('-g')
        if sep and gen.isdigit():
            return base, int(gen)
        return member, 0

    def spawn(self, base, gen=0):
        """Provisions + spawns one member, waits for its socket, joins
        it to the ring, and registers its durable store with the
        failover executor.  Returns the member id."""
        member = self._member_name(base, gen)
        sock_path = os.path.join(self.base_dir, member + '.sock')
        store_dir = os.path.join(self.base_dir, 'store-' + member)
        os.makedirs(store_dir, exist_ok=True)
        proc = P.spawn_server(
            sock_path, self.device, ['--replica-id', member, '--storage-dir',
                                     store_dir, '--durable', '--sync'],
            deadline_s=self.spawn_deadline_s)
        with self._lock:
            self._procs[member] = proc
            self._lineage.setdefault(self._parse(member)[0], 0)
        # pin existing docs to their current owners BEFORE the store
        # registration, so the joiner's own (possibly stale, gen-1)
        # blobs never pin anything
        pins = self.failover.join_pins() \
            if self.failover is not None and gen else None
        if self.failover is not None:
            self.failover.register_store(member, store_dir)
        self.router.add_member(member, sock_path, pins=pins)
        if gen:
            telemetry.metric('failover.rejoins')
            telemetry.recorder.record('fleet.rejoin', doc=member,
                                      n=gen)
        return member

    def spawn_fleet(self, n, prefix='r'):
        return [self.spawn('%s%d' % (prefix, i)) for i in range(n)]

    def proc(self, member):
        with self._lock:
            return self._procs.get(member)

    # -- the watcher ----------------------------------------------------

    def _run(self):
        while not self._stop.wait(0.05):
            with self._lock:
                procs = list(self._procs.items())
            for member, proc in procs:
                if proc.poll() is None or self._stop.is_set():
                    continue
                with self._lock:
                    self._procs.pop(member, None)
                self._on_exit(member, proc.returncode)

    def _on_exit(self, member, rc):
        """Kill detection: feed the health machine (whose monitor
        thread runs the failover), then respawn a new generation once
        the old id has left the ring."""
        cause = 'exit rc=%s' % rc
        if self.health is not None:
            self.health.mark_dead(member, cause=cause)
        elif self.failover is not None:
            self.failover.fail_over(member)
        base, gen = self._parse(member)
        with self._lock:
            self._lineage[base] = self._lineage.get(base, 0) + 1
            deaths = self._lineage[base]
        if deaths > self.flap_max:
            telemetry.metric('failover.quarantined')
            if self.health is not None:
                self.health.quarantine(member)
            print('supervisor: %r quarantined after %d deaths '
                  '(flap_max=%d)'
                  % (base, deaths, self.flap_max), file=sys.stderr)
            return
        # wait for the failover to remove the dead id (bounded): a
        # rejoiner added mid-failover would skew the re-placement
        deadline = time.monotonic() + 30.0
        while member in self.router.replicas \
                and time.monotonic() < deadline \
                and not self._stop.is_set():
            time.sleep(0.02)
        # capped-backoff respawn, scaled by the lineage's death count
        delay = min(0.1 * (2 ** (deaths - 1)), 2.0)
        if self._stop.wait(delay):
            return
        telemetry.metric('failover.respawns')
        try:
            self.spawn(base, gen + 1)
        except Exception as e:
            print('supervisor: respawn of %r failed: %s: %s'
                  % (base, type(e).__name__, e), file=sys.stderr)
