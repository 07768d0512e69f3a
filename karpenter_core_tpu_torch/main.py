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

Port of ``karpenter_core_tpu/main.py``, with the exit after a device fault
(below). With ``--solver tpu`` the operator solves on ``cuda``
(``Options``' default device) and building it raises without a GPU: it
never carries on on the CPU. ``--solver greedy`` runs the host solver
anywhere.

    python -m karpenter_core_tpu_torch.main --solver tpu --log-level debug
    python -m karpenter_core_tpu_torch.main --solver tpu --solver-mode sidecar

A sticky CUDA error in process (``Operator.device_fault``) ends the loop:
the binary logs its cause and exits ``DEVICE_FAULT_EXIT_CODE`` within a
fixed bound, its teardown run on a daemon thread that may not hold the
exit longer than ``TEARDOWN_TIMEOUT_S``. Its restart (the pod's liveness
probe or restart policy) gives it a fresh CUDA context, as the supervisor
gives solverd's child one.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional

from karpenter_core_tpu_torch.logging import configure
from karpenter_core_tpu_torch.operator import Operator, Options
from karpenter_core_tpu_torch.solver.supervisor import WATCHDOG_EXIT_CODE
from karpenter_core_tpu_torch.utils.device import describe_device_fault

# the crash-only exit after a sticky CUDA error: solverd's watchdog code,
# "restart me with a fresh context"
DEVICE_FAULT_EXIT_CODE = WATCHDOG_EXIT_CODE
# after a device fault: how long /healthz keeps answering 503 before the
# exit, and the most the teardown may take (it may meet the poisoned
# context and hang or raise)
FAULT_EXIT_GRACE_S = 1.0
TEARDOWN_TIMEOUT_S = 5.0


def _bounded(fn, timeout: float, logger) -> None:
    """Run ``fn`` on a daemon thread and wait at most ``timeout`` seconds;
    a raise is logged, a hang is left behind."""

    def run():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the exit must not wait
            logger.error("teardown after the device fault failed: %s", e)

    t = threading.Thread(target=run, name="fault-teardown", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        logger.error("teardown still running after %.1f s; exiting",
                     timeout)


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
    fault = None
    try:
        while True:
            op.reconcile_once()
            n += 1
            fault = op.device_fault
            if fault is not None:
                logger.error(
                    "sticky CUDA error after %d passes (%s): the context"
                    " is poisoned; exiting %d for a fresh process",
                    n, describe_device_fault(fault), DEVICE_FAULT_EXIT_CODE,
                )
                break
            if options.max_iters and n >= options.max_iters:
                break
            time.sleep(options.poll_interval)
    except KeyboardInterrupt:
        logger.info("operator interrupted after %d passes", n)
    finally:
        if fault is None:
            op.shutdown()
        else:
            _bounded(op.shutdown, TEARDOWN_TIMEOUT_S, logger)
            time.sleep(FAULT_EXIT_GRACE_S)  # /healthz answers 503 meanwhile
        if health is not None:
            health.shutdown()
            health.server_close()
    return 0 if fault is None else DEVICE_FAULT_EXIT_CODE


if __name__ == "__main__":
    code = main()
    if code == DEVICE_FAULT_EXIT_CODE:
        # crash-only: skip the interpreter's teardown, which may touch the
        # poisoned context
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(code)
