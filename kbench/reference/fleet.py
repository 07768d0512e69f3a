"""Plain reference checks of a solver fleet's grants.

Each member of a grant is one tenant's provisioning pass: a backlog of the
pool solved for the tenant's own NodePool. A seeded sample of the members
is held to the checks of a solve, as the ``provision`` entry holds its
solves (``check.py``, and ``pack.py`` for the NodeClaim count and price).
Two checks are the fleet's own:

* ``crossed``, on every member: the pods its answer names that are not of
  its own pass, and its NodeClaims of a NodePool not its tenant's. The
  members of a grant hold distinct backlogs, so an answer handed to the
  wrong member, or a pod of one tenant placed in another's answer, shows
  here;
* ``batched_vs_solo``, on each sampled member: whether its NodeClaims as
  canonical rows (the pods, the instance-type options, the zones and the
  NodePool of each, in a fixed order) differ from those of the same
  backlog solved alone, after the window, by a fresh scheduler of the same
  tenant. Coalescing changes which launch answers a scan, never the
  answer.

Reads only plain rows: the generator's, the catalog's and the answers read
back as rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from kbench.entries.provision import LIMITS as SOLVE_LIMITS
from kbench.reference import check as rcheck
from kbench.reference import pack as rpack

# the numbers compared: a solve's, and the fleet's two at 0
LIMITS = dict(SOLVE_LIMITS, crossed=(0, "max"), batched_vs_solo=(0, "max"))


def crossed(named: List[str], pools: List[str], own: frozenset,
            own_pool: str) -> int:
    """Pods named by a member's answer (``named``) outside its own pass
    (``own``), and its NodeClaims (``pools``, one a claim) of another
    NodePool."""
    return (sum(1 for n in named if n not in own)
            + sum(1 for p in pools if p != own_pool))


def canonical(answer: Optional[Dict]) -> Optional[List]:
    """An answer's NodeClaims as rows in a fixed order."""
    if answer is None:
        return None
    return sorted((tuple(sorted(c["pods"])), tuple(sorted(c["options"])),
                   tuple(c["zones"] or ()), c["pool"])
                  for c in answer["claims"])


def hold(members: List[Dict], backlogs: List[List[Dict]],
         catalog: List[Dict], traffic: Dict, pools: List[str],
         log) -> Dict:
    """The numbers compared (``LIMITS``) over the window's members: each a
    dict with ``tenant``, ``b`` (its backlog), ``failed``; a completed one
    ``named`` and ``pools``; a sampled one ``answer`` and ``solo``."""
    out = {"failed": sum(1 for m in members if m["failed"]),
           "violations": 0, "unplaced": 0, "options_wrong": 0,
           "nodeclaims_ratio": 0.0, "price_ratio": 0.0, "crossed": 0,
           "batched_vs_solo": 0}
    own: Dict[int, frozenset] = {}
    for m in members:
        if m["failed"]:
            continue
        b = m["b"]
        if b not in own:
            own[b] = frozenset(p["name"] for p in backlogs[b])
        out["crossed"] += crossed(m["named"], m["pools"], own[b],
                                  pools[m["tenant"]])
    held, claims, ref = 0, [], {}
    for m in members:
        if "answer" not in m:
            continue
        rows = backlogs[m["b"]]
        got = rcheck.check(rows, catalog, traffic, m["answer"])
        if m["b"] not in ref:
            ref[m["b"]] = rpack.pack(rows, catalog, traffic)
        want = ref[m["b"]]
        held += 1
        for k in ("violations", "unplaced"):
            out[k] += got[k]
        out["options_wrong"] = max(out["options_wrong"],
                                   got["options_wrong"])
        out["nodeclaims_ratio"] = max(
            out["nodeclaims_ratio"], got["nodeclaims"] / len(want["claims"]))
        out["price_ratio"] = max(out["price_ratio"],
                                 got["price"] / want["price"])
        claims.append(got["nodeclaims"])
        if canonical(m["answer"]) != canonical(m["solo"]):
            out["batched_vs_solo"] += 1
            log(f"member tenant {m['tenant']} backlog {m['b']}: its"
                " NodeClaims differ from the backlog solved alone")
        if got["violations"]:
            log(f"member tenant {m['tenant']} backlog {m['b']}:"
                f" {got['by_guarantee']}")
    log(f"reference: {held} members of {len(members)} held, each also"
        f" solved alone; NodeClaims {min(claims, default=0)}-"
        f"{max(claims, default=0)}; the reference's own"
        f" {sorted(len(w['claims']) for w in ref.values())};"
        f" crossed over every completed member {out['crossed']}")
    out["held"] = held
    return out
