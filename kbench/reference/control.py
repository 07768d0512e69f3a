"""The control: the reference put in the program's place with one of the
configuration's guarantees broken. The check has to find it not correct.

``solve`` is the reference packer (``pack.py``) with one guarantee left
out:

* ``topology``: topology spread and anti-affinity are ignored (pods of a
  cohort share NodeClaims and zones freely);
* ``memory``: memory requests are taken as free, so a NodeClaim holds as
  many pods as its cpu and pod count allow, and lists types by that.

Everything else it keeps. ``sweep`` is the sweep's reference with memory
taken as free (``reference/sweep.verdicts(broken="memory")``).
"""
from __future__ import annotations

from typing import Dict, List

from kbench.reference import pack
from kbench.reference import sweep as rsweep

BROKEN = pack.BROKEN


def solve(pods: List[Dict], catalog: List[Dict], traffic: Dict,
          broken: str) -> Dict:
    if broken not in BROKEN:
        raise ValueError(f"unknown guarantee {broken!r}")
    return pack.pack(pods, catalog, traffic, broken)


def sweep(state: Dict, catalog: List[Dict], max_slots: int):
    return rsweep.verdicts(state, catalog, max_slots, broken="memory")
