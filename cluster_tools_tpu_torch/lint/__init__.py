"""ctlint for the PyTorch port: static analysis of the runtime's contracts.

The port carries the reference package's reliability and IO stack, and its
guarantees hold only by convention: every executor call site must plumb
the hardening knobs, every shared manifest must be written atomically,
nothing may block while holding a card's dispatch lock or the chunk
cache's lock, every storage boundary must carry a fault-injection hook,
device work must be timed with a synchronization, and no broad ``except``
may swallow a preemption drain.  ``ctlint`` turns those conventions into
machine-checked rules with the reference's ids (docs/ANALYSIS.md):

- **CT001 executor-contract** — ``map_blocks`` / ``BlockwiseExecutor`` /
  ``host_block_map`` call sites must plumb the hardening knobs.
- **CT002 atomic-write discipline** — no bare ``json.dump`` to shared state
  without the temp-file + ``os.replace`` idiom (``fu.atomic_write_json``).
- **CT003 lock discipline** — no lock-order cycles across the runtime's
  locks; no blocking calls under a card's dispatch lock, its device-pool
  lock or the chunk-cache lock.
- **CT004 fault-site coverage** — storage/compute boundaries carry
  injection hooks; every hooked site name is in ``faults.py``'s registry.
- **CT005 device-work hygiene** — no timing of a hand kernel or a
  ``spmd.shard_map`` body without a synchronization; no draw from a
  global random generator in a per-shard body.
- **CT006 drain safety** — no handler that can swallow ``DrainInterrupt``;
  ``os._exit`` only in ``faults.py``; DAG entry points map drains to
  ``REQUEUE_EXIT_CODE``.
- **CT007-CT015** — the handoff spill contract, trace hygiene, the server,
  the journal, verified reads, the fleet, gray failures, the supervisor
  and the reduce plane, as in the reference.

Run ``python -m cluster_tools_tpu_torch.lint``; suppress a single finding
with ``# ctlint: disable=CTnnn`` on (or immediately above) the offending
line.  The module is pure stdlib/ast — it imports neither torch nor the
reference package, and never executes the code it checks.
"""

from __future__ import annotations

from .core import (  # noqa: F401
    Finding,
    LintModule,
    collect_files,
    findings_to_json,
    run_lint,
)
from .rules import RULES  # noqa: F401
