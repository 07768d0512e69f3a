"""Plain reference answer of a provisioning solve: the backlog packed onto
new NodeClaims by first-fit-decreasing, one pod at a time.

Pods are taken largest cpu first, then largest memory, then by name. A pod
joins the first NodeClaim opened that still holds it in the catalog's
roomiest type and whose constraints it keeps, or opens a new one:

* node affinity and nodeSelector: a NodeClaim's zones narrow to the
  zones its pods allow; a nodeSelector narrows the types;
* topology spread over zones, maxSkew 1: the pod takes the zone where its
  cohort has the fewest pods (ties to the first zone), and its NodeClaim
  is pinned there;
* topology spread over hostnames and hostname anti-affinity: at most one
  pod of a cohort on a NodeClaim.

Each NodeClaim may launch every type that holds its pods and meets their
requirements; the answer's price is the sum over NodeClaims of the
cheapest such type's cheapest offering. ``broken`` names a guarantee to
leave out, for the control (``control.py``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from kbench.reference import units

BROKEN = ("topology", "memory")
# node labels a nodeSelector may name, and the catalog field that holds each
LABEL_FIELDS = {"kubernetes.io/os": "os", "kubernetes.io/arch": "arch"}


def type_ok(t: Dict, selector: Dict) -> bool:
    """Whether catalog row ``t`` carries every label ``selector`` asks."""
    for k, v in selector.items():
        have = t.get(LABEL_FIELDS.get(k, k))
        if v not in (have if isinstance(have, list) else [have]):
            return False
    return True


def fitting(catalog: List[Dict], alloc: np.ndarray, need: np.ndarray,
            selector: Dict, zones) -> List[int]:
    """The types that hold ``need`` and meet the requirements."""
    return [i for i in np.nonzero(np.all(alloc >= need, axis=1))[0]
            if type_ok(catalog[i], selector)
            and set(zones) & set(catalog[i]["zones"])]


def pack(pods: List[Dict], catalog: List[Dict], traffic: Dict,
         broken: Optional[str] = None) -> Dict:
    if broken not in (None,) + BROKEN:
        raise ValueError(f"unknown guarantee {broken!r}")
    alloc = units.type_allocatable(catalog)
    price = units.cheapest_price(catalog)
    zones = sorted({z for t in catalog for z in t["zones"]})
    zonal = sorted(traffic.get("zonal_zones") or zones)
    selector = traffic.get("selector", {})
    cap = alloc[int(np.argmax(alloc[:, 0]))]
    topology = broken != "topology"
    spread: Dict[str, Dict[str, int]] = defaultdict(
        lambda: dict.fromkeys(zones, 0))
    n_max = len(pods)
    used = np.zeros((n_max, len(cap)), dtype=np.int64)
    zmask = np.ones((n_max, len(zones)), dtype=bool)
    members: List[List[Dict]] = []
    holds: Dict[str, List[int]] = defaultdict(list)  # cohort -> claims
    n = 0
    for p in sorted(pods, key=lambda p: (-p["cpu"], -p["memory"],
                                         p["name"])):
        r = units.request_vector(p)
        if broken == "memory":
            r[1] = 0
        allowed = np.ones(len(zones), dtype=bool)
        if p["kind"] == "zonal":
            allowed = np.isin(zones, zonal)
        if p["kind"] == "zone_spread" and topology:
            counts = spread[p["cohort"]]
            allowed = np.asarray(zones) == min(zones,
                                               key=lambda z: (counts[z], z))
        ok = np.all(used[:n] + r <= cap, axis=1) & np.any(
            zmask[:n] & allowed, axis=1)
        if topology and p["kind"] in ("host_spread", "anti"):
            ok[holds[p["cohort"]]] = False
        k = int(np.argmax(ok)) if ok.any() else n
        if k == n:
            n += 1
            members.append([])
        used[k] += r
        zmask[k] &= allowed
        members[k].append(p)
        if p["cohort"] is not None:
            holds[p["cohort"]].append(k)
        if p["kind"] == "zone_spread":
            spread[p["cohort"]][zones[int(np.argmax(zmask[k]))]] += 1
    claims, total = [], 0.0
    for k, m in enumerate(members):
        zs = [z for z, on in zip(zones, zmask[k]) if on]
        sel = selector if any(p["kind"] == "selector" for p in m) else {}
        opts = fitting(catalog, alloc, used[k], sel, zs)
        total += float(price[opts].min())
        claims.append({"pods": [p["name"] for p in m],
                       "options": [catalog[i]["name"] for i in opts],
                       "zones": zs})
    return {"claims": claims, "existing": [], "errors": [], "price": total}
