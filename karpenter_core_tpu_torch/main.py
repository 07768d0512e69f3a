"""Operator CLI entry point (reference: kwok/main.go:28-47).

Builds the full controller stack over the in-memory store + kwok provider
and runs the reconcile loop. Flags/env parse through Options.parse
(--solver greedy|tpu, --solver-mode inproc|sidecar, --solver-backend
ffd|relax, --kernel cuda|reference (FFD-scan kernel implementation:
the hand-written CUDA kernel vs its plain torch version — bit-identical
results, a latency lever), --solver-addr,
--solver-timeout, --solver-verify true|false (host-side verification of
every device/sidecar result — on by default), --batch-max-duration,
--batch-idle-duration, --log-level, --feature-gates Name=true,...), plus
loop controls:
--poll-interval seconds between passes, --max-iters to bound the run
(0 = run until interrupted).

Port of ``karpenter_core_tpu/main.py``; only this docstring differs. With
``--solver tpu`` the operator solves on ``cuda`` (``Options``' default
device) and building it raises without a GPU: it never carries on on the
CPU. ``--solver greedy`` runs the host solver anywhere.

    python -m karpenter_core_tpu_torch.main --solver tpu --log-level debug
    python -m karpenter_core_tpu_torch.main --solver tpu --solver-mode sidecar
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

from karpenter_core_tpu_torch.logging import configure
from karpenter_core_tpu_torch.operator import Operator, Options


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    options = Options.parse(argv)
    logger = configure(options.log_level)

    op = Operator(options=options)
    health = None
    if options.health_port:
        from karpenter_core_tpu_torch.healthserver import start_health_server

        port = 0 if options.health_port < 0 else options.health_port
        health = start_health_server(op, port)
        # log the ACTUAL listen address — the server binds 0.0.0.0 by
        # default, not loopback
        logger.info(
            "health/metrics on %s:%d (/healthz /readyz /metrics)",
            health.server_address[0],
            health.server_address[1],
        )
    if op.solver_client is not None:
        logger.info("solver sidecar at %s", op.solver_client.addr)
    logger.info(
        "operator starting: solver=%s mode=%s batch=%ss/%ss gates=%s",
        options.solver,
        options.solver_mode,
        options.batch_max_duration,
        options.batch_idle_duration,
        options.feature_gates,
    )
    n = 0
    try:
        while True:
            op.reconcile_once()
            n += 1
            if options.max_iters and n >= options.max_iters:
                break
            time.sleep(options.poll_interval)
    except KeyboardInterrupt:
        logger.info("operator interrupted after %d passes", n)
    finally:
        op.shutdown()
        if health is not None:
            health.shutdown()
            health.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
