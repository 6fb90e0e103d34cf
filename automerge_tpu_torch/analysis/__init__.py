"""automerge_tpu_torch.analysis -- the port's static gate and its
runtime alias sanitizer.

Four checkers, run over `automerge_tpu_torch/` by
`python -m automerge_tpu_torch.tools.static_check`:

  * **lock-discipline** (`check_locks`): ``# guarded-by: <lock>``
    attribute annotations enforced -- annotated attributes may only be
    touched inside ``with <lock>``.
  * **telemetry-key** (`check_telemetry`): every statically reachable
    flat-counter key is pre-seeded in its ``KNOWN_*`` block and
    documented (docs/OBSERVABILITY.md, docs/RESILIENCE.md or the port's
    `glossary.md`); a seeded or glossary key with no emit site is dead,
    and a documented key the port does not emit needs a reasoned
    exemption in the glossary.
  * **dispatch-alias** (`check_alias`): host numpy buffers handed to a
    torch host->device seam (`torch.from_numpy`, `ops.registers.upload`)
    and mutated after, C++ column views uploaded without a private copy,
    and asynchronous host->device copies outside `upload`.
    `sanitize.py` is the runtime sibling (`sanitize.arm()` poisons
    staging buffers after they were consumed).
  * **env-latch** (`check_env`): the port reads no ``AMTPU_*``
    variable; `env_spec.PORT_KNOBS` maps each flag of the JAX package to
    the port's module constant (or says why there is none), and the
    C++ core's ``getenv`` sites and latch defaults are held to it.

The engine (`engine.py`) parses each file once and hands the shared
sources to every checker.
"""

from .engine import Finding, run_checks  # noqa: F401
