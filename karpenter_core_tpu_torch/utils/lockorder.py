"""Opt-in runtime lock-order witness (``GRAFT_LOCK_WITNESS=1``).

graftlint's GL701 derives the solver tier's acquired-while-held graph
statically (tools/graftlint/dataflow.LockDataflow); this shim records
the graph that ACTUALLY happens at runtime, so a chaos soak can assert
the dynamic view stays inside the static one — the two cannot drift
without a test failing. The tier's current static graph has no edges at
all (one lock at a time, by design), which makes the soak's assertion
maximally strict: any runtime nesting of two witnessed locks is a
finding.

Zero-cost when disarmed: production code never imports this module; the
soak (tests/test_lockorder_witness.py) wraps lock attributes on live
objects explicitly via :func:`wrap`, and ``maybe_wrap`` is a no-op
unless the environment opts in.

Lock ids use GL701's identity scheme — ``"ClassName.attr"`` — so the
observed edges compare directly against
``dataflow.get_locks(files).order_edges``.
"""
from __future__ import annotations

import os
import threading
from typing import Iterable, Optional, Set, Tuple

ENV_FLAG = "GRAFT_LOCK_WITNESS"


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") == "1"


class LockWitness:
    """Per-thread held stacks, one process-global edge set.

    ``edges`` accumulates every (held_id, acquired_id) pair observed:
    thread T acquired the second lock while still holding the first.
    Re-entrant re-acquisition of the same id records nothing (RLock
    helpers are the tier's designed idiom, and GL701 skips them too).
    """

    def __init__(self) -> None:
        self._tls = threading.local()
        self._edges_lock = threading.Lock()
        self.edges: Set[Tuple[str, str]] = set()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def acquired(self, lock_id: str) -> None:
        st = self._stack()
        new = [
            (held, lock_id) for held in set(st)
            if held != lock_id and (held, lock_id) not in self.edges
        ]
        if new:
            with self._edges_lock:
                self.edges.update(new)
        st.append(lock_id)

    def released(self, lock_id: str) -> None:
        st = self._stack()
        # drop the most recent acquisition of this id (LIFO discipline,
        # tolerant of out-of-order releases from acquire/release pairs)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == lock_id:
                del st[i]
                break

    def reset(self) -> None:
        with self._edges_lock:
            self.edges.clear()

    def assert_within(self, static_edges: Iterable[Tuple[str, str]]) -> None:
        """Every observed edge must exist in the static GL701 graph."""
        allowed = set(static_edges)
        stray = sorted(e for e in self.edges if e not in allowed)
        if stray:
            lines = "\n".join(f"  {s} -> {d}" for s, d in stray)
            raise AssertionError(
                "runtime lock acquisitions outside the static lock-order"
                f" graph:\n{lines}\n"
                "either the code grew a nesting GL701 cannot see (fix the"
                " static domain) or a genuinely new nesting shipped (run"
                " graftlint and fix the order)"
            )


_WITNESS = LockWitness()


def witness() -> LockWitness:
    """The process-global witness the wrappers report to by default."""
    return _WITNESS


class WitnessedLock:
    """A Lock/RLock/Condition proxy that reports acquisition order.

    Forwards everything else untouched, so ``with``, ``acquire(timeout=)``
    and Condition methods behave identically to the wrapped primitive.
    """

    def __init__(
        self,
        inner,
        lock_id: str,
        witness_obj: Optional[LockWitness] = None,
    ) -> None:
        self._inner = inner
        self._id = lock_id
        self._witness = witness_obj if witness_obj is not None else _WITNESS

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._witness.acquired(self._id)
        return got

    def release(self) -> None:
        self._witness.released(self._id)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __getattr__(self, name):
        # Condition.wait/notify and friends pass straight through
        return getattr(self._inner, name)


def wrap(
    obj,
    attr: str,
    lock_id: str,
    witness_obj: Optional[LockWitness] = None,
) -> WitnessedLock:
    """Swap ``obj.<attr>`` for a witnessed proxy and return it.

    Unconditional — the soak calls this explicitly on the objects it
    drives. ``lock_id`` must use GL701's "ClassName.attr" identity so
    observed edges compare against the static graph.
    """
    proxy = WitnessedLock(getattr(obj, attr), lock_id, witness_obj)
    setattr(obj, attr, proxy)
    return proxy


def maybe_wrap(
    obj,
    attr: str,
    lock_id: str,
    witness_obj: Optional[LockWitness] = None,
):
    """:func:`wrap`, gated on ``GRAFT_LOCK_WITNESS=1`` — safe to sprinkle
    into debug/soak harness setup paths."""
    if not enabled():
        return getattr(obj, attr)
    return wrap(obj, attr, lock_id, witness_obj)
