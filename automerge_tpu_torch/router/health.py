"""Fleet health monitor (docs/RESILIENCE.md fleet degradation
tiers).

One state machine per ring member, fed by two signal paths that an
unplanned replica death can surface through:

  * **heartbeat probes** -- a monitor thread pings every member on its
    own dedicated probe socket each ``FLEET_HEARTBEAT_S``, with a
    hard per-probe deadline (``FLEET_DEADLINE_S``, enforced by a
    socket timeout so a hung-but-connected replica still counts as a
    miss).  The probe path carries the ``router.heartbeat`` fault site
    (member id as the doc scope), so chaos lanes drive the ladder
    deterministically.
  * **transport death** -- the router's per-connection upstream pumps
    report a died replica socket (`_upstream_dead`); that feeds the
    same machine as an immediate miss, so detection is not bounded by
    the probe period when real traffic notices first.

States::

    up --miss--> suspect --(misses >= FLEET_MISS_MAX)--> dead
        <--ok---         --(supervisor flap cap)--> quarantined

Consecutive-miss hysteresis: one miss only *suspects* a member (GC
pause, flush stall); while suspect, the router parks mutating frames
for that member's docs in the per-doc FIFOs instead of failing them
(bounded by ``FLEET_PARK_MB`` bytes and ``FLEET_PARK_S``
seconds -- the gateway enforces both).  A probe answering again
releases the parks in arrival order; ``FLEET_MISS_MAX``
consecutive misses declare the member dead and hand it to the failover
executor (``on_dead``), which runs on THIS monitor thread -- never on
a transport pump -- so fail-over never blocks the data path.

`dead` and `quarantined` are terminal for a member *id*: a supervised
respawn rejoins as a NEW member (router/supervisor.py), and this
monitor keeps the dead entry for the healthz ``fleet_health`` section
until it is forgotten.
"""

import json
import socket
import struct
import sys
import threading
import time

from .. import faults, telemetry

#: seconds between heartbeat rounds (the JAX package's
#: AMTPU_FLEET_HEARTBEAT_S)
FLEET_HEARTBEAT_S = 0.5
#: seconds one probe may take before it counts as a miss
#: (AMTPU_FLEET_DEADLINE_S)
FLEET_DEADLINE_S = 0.5
#: consecutive misses that declare a member dead (AMTPU_FLEET_MISS_MAX)
FLEET_MISS_MAX = 3

#: member states, in degradation order
UP, SUSPECT, DEAD, QUARANTINED = 'up', 'suspect', 'dead', 'quarantined'


class HealthMonitor(object):
    """Per-member up/suspect/dead state machine + heartbeat prober.

    ``on_dead(member)`` is the failover hook (typically
    ``FailoverExecutor.fail_over``); it is invoked from the monitor
    thread after the state transition is already visible, so the
    gateway's park checks and the executor never race the machine.
    """

    def __init__(self, router, heartbeat_s=None, deadline_s=None,
                 miss_max=None, on_dead=None):
        self.router = router
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None \
            else FLEET_HEARTBEAT_S
        self.deadline_s = deadline_s if deadline_s is not None \
            else FLEET_DEADLINE_S
        self.miss_max = max(1, miss_max if miss_max is not None
                            else FLEET_MISS_MAX)
        self.on_dead = on_dead
        self._lock = threading.Lock()
        self._members = {}       # guarded-by: self._lock
        self._pending_dead = []  # guarded-by: self._lock
        self._socks = {}         # probe sockets; monitor thread only
        self._hb_id = 0          # monitor thread only
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ------------------------------------------------------

    def start(self):
        telemetry.register_healthz_section('fleet_health',
                                           self._healthz_section)
        self.router.attach_health(self)
        self._thread = threading.Thread(target=self._run,
                                        name='amtpu-fleet-health',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for member in list(self._socks):
            self._drop_sock(member)
        telemetry.register_healthz_section('fleet_health', None)
        if getattr(self.router, '_health', None) is self:
            self.router.attach_health(None)

    # -- state machine --------------------------------------------------

    def _ensure(self, member):  # holds-lock: self._lock
        st = self._members.get(member)
        if st is None:
            st = {'state': UP, 'misses': 0,
                  'since': time.monotonic(),
                  'last_ok': time.monotonic()}
            self._members[member] = st
        return st

    def state(self, member):
        """The member's current state (an unseen member counts `up`)."""
        with self._lock:
            st = self._members.get(member)
            return st['state'] if st is not None else UP

    def is_parking(self, member):
        """While a member is suspect OR dead-but-not-yet-failed-over,
        mutating frames for its docs park instead of failing."""
        return self.state(member) in (SUSPECT, DEAD)

    def members(self):
        """Snapshot for rendering: {member: {state, misses, for_s}}."""
        now = time.monotonic()
        with self._lock:
            return {m: {'state': st['state'], 'misses': st['misses'],
                        'for_s': round(now - st['since'], 3)}
                    for m, st in self._members.items()}

    def note_ok(self, member):
        with self._lock:
            st = self._members.get(member)
            if st is None or st['state'] in (DEAD, QUARANTINED):
                return
            st['misses'] = 0
            st['last_ok'] = time.monotonic()
            recovered = st['state'] == SUSPECT
            if recovered:
                st['state'] = UP
                st['since'] = time.monotonic()
        if recovered:
            telemetry.metric('router.health.recoveries')
            self.router.release_member_parks(member)

    def note_miss(self, member, cause='probe'):
        now = time.monotonic()
        with self._lock:
            st = self._ensure(member)
            if st['state'] in (DEAD, QUARANTINED):
                return
            st['misses'] += 1
            suspected = st['state'] == UP
            if suspected:
                st['state'] = SUSPECT
                st['since'] = now
            died = st['misses'] >= self.miss_max
            if died:
                st['state'] = DEAD
                st['since'] = now
                self._pending_dead.append(member)
        telemetry.metric('router.health.misses')
        if suspected:
            telemetry.metric('router.health.suspects')
            telemetry.recorder.record('fleet.suspect', doc=member,
                                      n=1, detail=cause)
        if died:
            telemetry.metric('router.health.deaths')
            telemetry.recorder.record('fleet.dead', doc=member,
                                      n=1, detail=cause)

    def note_transport_death(self, member):
        """An upstream data socket died mid-stream -- stronger than a
        probe timeout (the kernel told us), so it suspects immediately
        without waiting for the next heartbeat tick."""
        self.note_miss(member, cause='transport')

    def mark_dead(self, member, cause='kill'):
        """Out-of-band kill detection (the supervisor watched the
        process exit): straight to dead, skipping hysteresis."""
        with self._lock:
            st = self._ensure(member)
            if st['state'] in (DEAD, QUARANTINED):
                return
            st['state'] = DEAD
            st['since'] = time.monotonic()
            self._pending_dead.append(member)
        telemetry.metric('router.health.deaths')
        telemetry.recorder.record('fleet.dead', doc=member, n=1,
                                  detail=cause)

    def quarantine(self, member):
        """Flap cap reached (router/supervisor.py): the member id is
        barred from the ring; only rendering distinguishes this from
        dead."""
        with self._lock:
            st = self._ensure(member)
            st['state'] = QUARANTINED
            st['since'] = time.monotonic()

    def forget(self, member):
        with self._lock:
            self._members.pop(member, None)
        self._drop_sock(member)

    # -- prober ---------------------------------------------------------

    def _run(self):
        while not self._stop.wait(self.heartbeat_s):
            for member in sorted(self.router.replicas):
                if self._stop.is_set():
                    return
                with self._lock:
                    st = self._ensure(member)
                    if st['state'] in (DEAD, QUARANTINED):
                        continue
                telemetry.metric('router.health.probes')
                if self._probe(member):
                    self.note_ok(member)
                else:
                    self.note_miss(member)
            self._fire_dead()
            self.router.sweep_parked()

    def _fire_dead(self):
        while True:
            with self._lock:
                if not self._pending_dead:
                    return
                member = self._pending_dead.pop(0)
            if self.on_dead is None:
                continue
            try:
                self.on_dead(member)
            except Exception as e:
                # a failed fail-over leaves the member dead and its
                # parks to expire via the sweep -- never kill the
                # monitor thread that detects everything else
                print('fleet-health: failover for %r failed: %s: %s'
                      % (member, type(e).__name__, e), file=sys.stderr)

    def _probe(self, member):
        """One deadline-bounded ping on the member's dedicated probe
        socket.  Runs only on the monitor thread, so the socket cache
        needs no lock."""
        try:
            if faults.ARMED:
                faults.fire('router.heartbeat', docs=(member,))
            sock = self._socks.get(member)
            if sock is None:
                path = self.router.replicas.get(member)
                if path is None:
                    return False
                sock = socket.socket(socket.AF_UNIX,
                                     socket.SOCK_STREAM)
                sock.settimeout(self.deadline_s)
                sock.connect(path)
                self._socks[member] = sock
            self._hb_id += 1
            req = {'id': '__amtpu_hb:%d' % self._hb_id, 'cmd': 'ping'}
            if self.router.use_msgpack:
                import msgpack
                body = msgpack.packb(req, use_bin_type=True)
                sock.sendall(struct.pack('>I', len(body)) + body)
                head = self._recv_exact(sock, 4)
                (n,) = struct.unpack('>I', head)
                resp = msgpack.unpackb(self._recv_exact(sock, n),
                                       raw=False, strict_map_key=False)
            else:
                sock.sendall((json.dumps(req) + '\n').encode())
                resp = json.loads(self._recv_line(sock))
            return isinstance(resp, dict) \
                and (resp.get('result') or {}).get('ok') is True
        except (OSError, ValueError, KeyError,
                faults.TransientFault, faults.PermanentFault):
            self._drop_sock(member)
            return False

    @staticmethod
    def _recv_exact(sock, n):
        buf = b''
        while len(buf) < n:
            got = sock.recv(n - len(buf))
            if not got:
                raise ConnectionError('probe socket closed')
            buf += got
        return buf

    @staticmethod
    def _recv_line(sock):
        buf = b''
        while not buf.endswith(b'\n'):
            got = sock.recv(4096)
            if not got:
                raise ConnectionError('probe socket closed')
            buf += got
        return buf

    def _drop_sock(self, member):
        sock = self._socks.pop(member, None)
        if sock is not None:
            try:
                sock.close()
            except Exception:
                pass

    # -- observability --------------------------------------------------

    def _healthz_section(self):
        out = {'members': self.members(),
               'heartbeat_s': self.heartbeat_s,
               'deadline_s': self.deadline_s,
               'miss_max': self.miss_max}
        out.update(self.router.park_stats())
        return out
