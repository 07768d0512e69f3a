"""Plain reference check of a provisioning solve's whole answer.

Given the backlog's pod rows, the catalog rows and the answer read back as
plain rows (``lib/port.answer_rows``), it works out from the rows alone
whether every guarantee the configuration states holds:

* each pod of the backlog is placed once, or left unschedulable only if
  no instance type could ever hold it; no pod outside the backlog appears;
* every instance type a NodeClaim may launch holds the sum of its pods'
  requests (cpu, memory, pods) within its allocatable, in integer units;
* node affinity: a zonal pod's NodeClaim may launch only in the pod's
  zones; a nodeSelector pod's NodeClaim only on types whose labels match;
* topology spread over zones, maxSkew 1: each such pod's NodeClaim is
  pinned to one zone, and the cohort's counts over every zone of the
  catalog differ by at most 1;
* topology spread over hostnames, maxSkew 1, and hostname anti-affinity:
  at most one pod of a cohort on a NodeClaim (a new node is always an
  empty domain, so the minimum is 0);
* instance-type choices: a NodeClaim lists exactly the types that hold
  its pods and meet their requirements (``pack.fitting``), no more and no
  fewer.

It counts violations by guarantee, the pods not placed, the NodeClaims
whose options are wrong, and the answer's NodeClaims and price (the sum
over NodeClaims of the cheapest option's cheapest offering), which the
caller holds against the reference's own answer (``pack.py``).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List

import numpy as np

from kbench.reference import pack, units


def check(pods: List[Dict], catalog: List[Dict], traffic: Dict,
          answer: Dict) -> Dict:
    by_name = {p["name"]: p for p in pods}
    types = {t["name"]: i for i, t in enumerate(catalog)}
    alloc = units.type_allocatable(catalog)
    price = units.cheapest_price(catalog)
    total_price = 0.0
    options_wrong = 0
    zones_all = sorted({z for t in catalog for z in t["zones"]})
    viol: Counter = Counter()
    seen: Counter = Counter()
    zone_counts: Dict[str, Counter] = defaultdict(Counter)
    selector = traffic.get("selector", {})
    zonal = set(traffic.get("zonal_zones", ()))

    for claim in answer["claims"]:
        opts = [types.get(o) for o in claim["options"]]
        if not opts or None in opts:
            viol["options"] += 1
            continue
        members = []
        for name in claim["pods"]:
            seen[name] += 1
            if name in by_name:
                members.append(by_name[name])
            else:
                viol["unknown_pod"] += 1
        need = sum((units.request_vector(p) for p in members),
                   np.zeros(len(units.RESOURCES), dtype=np.int64))
        if not np.all(alloc[opts] >= need[None, :]):
            viol["capacity"] += 1
        zones = claim["zones"] if claim["zones"] is not None else zones_all
        total_price += float(price[opts].min())
        sel = (selector if any(p["kind"] == "selector" for p in members)
               else {})
        options_wrong += set(opts) != set(
            pack.fitting(catalog, alloc, need, sel, zones))
        cohorts = Counter(p["cohort"] for p in members
                          if p["kind"] in ("host_spread", "anti"))
        viol["hostname"] += sum(1 for n in cohorts.values() if n > 1)
        for p in members:
            if p["kind"] == "zonal" and not set(zones) <= zonal:
                viol["node_affinity"] += 1
            if p["kind"] == "selector" and not all(
                    pack.type_ok(catalog[i], selector) for i in opts):
                viol["node_selector"] += 1
            if p["kind"] == "zone_spread":
                if len(zones) != 1:
                    viol["zone_spread"] += 1
                else:
                    zone_counts[p["cohort"]][zones[0]] += 1
    for names in answer.get("existing", ()):
        for name in names:
            seen[name] += 1
            if name not in by_name:
                viol["unknown_pod"] += 1
    for counts in zone_counts.values():
        per_zone = [counts.get(z, 0) for z in zones_all]
        if max(per_zone) - min(per_zone) > 1:
            viol["zone_spread"] += 1
    viol["duplicate_pod"] += sum(1 for n in seen.values() if n > 1)
    errors = set(answer["errors"])
    biggest = alloc.max(axis=0)
    unplaced = 0
    for p in pods:
        if seen[p["name"]] == 0:
            placeable = bool(np.all(units.request_vector(p) <= biggest))
            unplaced += placeable
            if not placeable and p["name"] not in errors:
                viol["lost_pod"] += 1
    total = sum(units.request_vector(p) for p in pods)
    by_cohort = Counter(p["cohort"] for p in pods
                        if p["kind"] in ("host_spread", "anti"))
    bound = max([int(np.ceil(total[0] / biggest[0]))]
                + list(by_cohort.values()))
    return {"violations": int(sum(viol.values())),
            "by_guarantee": {k: int(v) for k, v in viol.items() if v},
            "unplaced": int(unplaced),
            "options_wrong": int(options_wrong),
            "price": total_price,
            "nodeclaims": len(answer["claims"]),
            "nodeclaims_lower_bound": int(bound)}
