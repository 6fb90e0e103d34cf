"""automerge_tpu_torch.scheduler -- the continuous-batching serve gateway.

Turns the single-connection sidecar into a multi-client server that
coalesces concurrent mutating requests across connections into full
device batches under a latency deadline, with admission control and
SLO telemetry.  Architecture + tunables: docs/SERVING.md.
"""

from .egress import EgressQueue  # noqa: F401
from .gateway import (BATCH_CMDS, EXEC_CMDS, PURE_CMDS,  # noqa: F401
                      READ_CMDS, GatewayServer)
from .queue import (AdmissionQueue, Overloaded,  # noqa: F401
                    PendingOp, flush_deadline_s, max_batch_docs,
                    max_batch_ops)
