"""Digital twin: a time-compressed, seeded-deterministic simulation of the
FULL operator loop (ROADMAP item 5, PAPER.md §7's kwok-style closed loop).

N simulated clusters — independent ``Operator``s with distinct catalogs —
run against one shared solverd tier (in-thread daemons behind each
operator's ``FleetRouter``) under scripted and rate-seeded fault schedules
composed from the chaos harness seams plus fleet-level faults (member
murder mid-solve, operator↔fleet partition windows, segment-store
amnesia). A virtual clock threads through every TTL/backoff surface so
days of churn replay in minutes; invariant monitors assert pod
conservation, gang atomicity, eviction-budget compliance and
zero-verifier-rejections at every virtual tick; a ledger accumulates
$-cost, time-to-bind SLOs, preemption burn and solver-tier utilization
over virtual time. ``twin/shrink.py`` fuzzes seeded scenarios and shrinks
any invariant violation to a minimal JSON repro a pytest replays
byte-deterministically.
"""
from karpenter_core_tpu_torch.twin.clock import VirtualClock
from karpenter_core_tpu_torch.twin.harness import DigitalTwin, TwinResult
from karpenter_core_tpu_torch.twin.invariants import InvariantMonitor, Violation
from karpenter_core_tpu_torch.twin.ledger import Ledger
from karpenter_core_tpu_torch.twin.scenario import (
    FleetFault,
    Scenario,
    Storm,
    TestHook,
    WorkloadWave,
    decode_scenario,
    encode_scenario,
    scenario_fingerprint,
    scenario_from_json,
    scenario_to_json,
)
from karpenter_core_tpu_torch.twin.shrink import fuzz, replay, save_repro, shrink

__all__ = [
    "DigitalTwin",
    "FleetFault",
    "InvariantMonitor",
    "Ledger",
    "Scenario",
    "Storm",
    "TestHook",
    "TwinResult",
    "VirtualClock",
    "Violation",
    "WorkloadWave",
    "decode_scenario",
    "encode_scenario",
    "fuzz",
    "replay",
    "save_repro",
    "scenario_fingerprint",
    "scenario_from_json",
    "scenario_to_json",
    "shrink",
]
