"""Fleet routing tier over the port's replicas (docs/SERVING.md
routing section).

One gateway over one pool cannot serve millions of users.  This
package fronts N shared-nothing gateway+pool replicas with a
:class:`~automerge_tpu_torch.router.gateway.RouterGateway` speaking the
sidecar's existing JSONL/msgpack framing, places docs on a
consistent-hash ring (:mod:`automerge_tpu_torch.router.ring`), and moves
hot docs between replicas live
(:mod:`automerge_tpu_torch.router.rebalance`) without losing, duplicating,
or reordering a single op.

Failover: :mod:`automerge_tpu_torch.router.health` detects
replica death (heartbeats + transport signals), :mod:`.failover`
re-places a dead member's docs onto ring survivors from durable
storage, and :mod:`.supervisor` respawns router-managed replicas with
capped backoff -- docs/RESILIENCE.md "fleet degradation tiers" is the
contract.  Placement, wire envelopes and the journal are the JAX
package's (`tests/test_torch_router.py` holds them byte-equal).
"""

from .ring import HashRing                      # noqa: F401
from .gateway import RouterGateway              # noqa: F401
from .rebalance import (MigrationExecutor,      # noqa: F401
                        Rebalancer)
from .health import HealthMonitor               # noqa: F401
from .failover import FailoverExecutor          # noqa: F401
from .supervisor import ReplicaSupervisor       # noqa: F401
