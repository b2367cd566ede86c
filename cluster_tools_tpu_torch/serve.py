"""Service-mode CLI entry: run the resident pipeline server.

Port of ``cluster_tools_tpu/serve.py``.  Usage (docs/SERVING.md)::

    python -m cluster_tools_tpu_torch.serve --base-dir /srv/ctt \\
        [--port 0] [--max-workers 2] [--config server.json]
    python -m cluster_tools_tpu_torch.serve --status /srv/ctt

The server binds 127.0.0.1 on ``--port`` (0 = ephemeral; the bound port is
written to ``<base_dir>/server.json`` for clients), admits workflow
requests per-tenant (``--config`` names a JSON document with ``tenants`` /
``default_quota`` / ``max_workers`` / ``default_est_bytes`` /
``max_replay_attempts`` keys), and serves until a SIGTERM drains it —
in-flight requests finish at their safe boundaries, queued ones stay
journaled for the restart's replay, and the process exits
``REQUEUE_EXIT_CODE`` (114) so rolling restarts ride the standard
requeue protocol.  Every acknowledged request is recorded in the durable
submission journal (``<base_dir>/journal.log``, docs/SERVING.md
"Durability"): after ANY exit — drain or ``kill -9`` — the restarted
server replays acknowledged-but-incomplete requests to completion and
quarantines one that keeps crashing it (``max_replay_attempts``, default
3).  ``--status`` prints a running server's ``/status`` document and
exits with its ``rc`` field (the ``failures_report.py --json``
contract).

Requests run on the card unless their payload names ``"target":
"local"`` (the CPU).  The reference's ``--tpu`` flag only skipped a JAX
platform pin and has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_server_config(path):
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def cmd_status(base_dir: str) -> int:
    from .runtime.server import ServeClient

    client = ServeClient.from_endpoint_file(base_dir)
    doc = client.status()
    print(json.dumps(doc, indent=2))
    return int(doc.get("rc") or 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cluster_tools_tpu_torch.serve",
        description="resident multi-tenant pipeline server (docs/SERVING.md)",
    )
    p.add_argument("--base-dir", required=False,
                   help="server scratch dir (state, failures.json, request "
                        "tmp folders)")
    p.add_argument("--port", type=int, default=0,
                   help="bind port (default 0 = ephemeral, see server.json)")
    p.add_argument("--max-workers", type=int, default=None,
                   help="concurrent request executors (default 2)")
    p.add_argument("--config", default=None,
                   help="server config json: tenants/default_quota/"
                        "max_workers/default_est_bytes")
    p.add_argument("--status", metavar="BASE_DIR", default=None,
                   help="print a running server's /status and exit with "
                        "its rc")
    args = p.parse_args(argv)

    if args.status:
        return cmd_status(args.status)
    if not args.base_dir:
        p.error("--base-dir is required (unless --status)")

    from .runtime.journal import Fenced
    from .runtime.server import PipelineServer
    from .runtime.supervision import (
        FENCED_EXIT_CODE,
        REQUEUE_EXIT_CODE,
        DrainInterrupt,
        install_drain_handler,
    )

    cfg = _load_server_config(args.config)
    server = PipelineServer(
        base_dir=args.base_dir,
        tenants=cfg.get("tenants"),
        default_quota=cfg.get("default_quota"),
        max_workers=(
            args.max_workers
            if args.max_workers is not None
            else int(cfg.get("max_workers", 2))
        ),
        default_est_bytes=int(cfg.get("default_est_bytes", 0)),
        default_max_jobs=int(cfg.get("default_max_jobs", 2)),
        port=args.port,
        max_replay_attempts=int(cfg.get("max_replay_attempts", 3)),
        # self-healing plane (docs/SERVING.md "Self-healing"): scrubber
        # knobs ({"enabled", "interval_s", "bytes_per_interval", "roots"})
        # and the boot-time journal rotation threshold
        scrub=cfg.get("scrub"),
        journal_rotate_bytes=cfg.get("journal_rotate_bytes"),
    )
    install_drain_handler()
    server.start()
    replay = server.journal_health() or {}
    print(
        f"serving on {server.host}:{server.port} "
        f"(base_dir={os.path.abspath(args.base_dir)}, "
        f"workers={server.max_workers}; journal replay: "
        f"{replay.get('replayed', 0)} replayed, "
        f"{replay.get('reenqueued', 0)} re-enqueued, "
        f"{replay.get('quarantined', 0)} quarantined)",
        flush=True,
    )
    try:
        server.serve_until_drained()
    except Fenced as e:
        # this member was declared dead and its journal adopted while it
        # was wedged: NOT a requeue — a survivor owns the journal
        print(
            f"FENCED ({e}); exiting {FENCED_EXIT_CODE} — journal "
            "adopted away, do not requeue",
            flush=True,
        )
        return FENCED_EXIT_CODE
    except DrainInterrupt as e:
        # a drained server is a requeue, not a crash — the supervisor
        # restarts it and the journal replays its queued work
        print(
            f"DRAINED ({e.reason}); exiting {REQUEUE_EXIT_CODE} for requeue",
            flush=True,
        )
        return REQUEUE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
