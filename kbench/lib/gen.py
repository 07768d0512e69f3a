"""The one generator of the benchmark's inputs: plain rows from the seed.

Every traffic mix is a data file under ``kbench/traffic/`` that this module
reads; nothing here is specific to one mix. Rows are plain dicts, handed
to the program (through ``lib/port.py``) and to the reference alike.

Each backlog and each cluster state draws its sizes from a stream of its
own (the run's seed and the backlog's or state's index): every pod's
request shape and label, and every node's free capacity, are drawn
uniformly from the traffic file's lists, as upstream's benchmark draws
them (``randomCPU``, ``randomMemory``, ``randomLabelValue``). The split of
a backlog over kinds, the node count and the candidate count are fixed.
So backlogs differ in their class counts, between backlogs of one run and
between seeds, while the work a run asks for is the same on average.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MIB = 2.0**20


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole seed, negative or
    past 64 bits, maps to one stream."""
    return np.random.default_rng([seed % 2**64, *keys])


def kind_counts(traffic: Dict) -> List[int]:
    """Pods of each kind: ``pods // kinds`` each, the rest to the first
    kind (upstream's ``makeDiversePods``)."""
    kinds = traffic["kinds"]
    each = traffic["pods"] // len(kinds)
    counts = [each] * len(kinds)
    counts[0] += traffic["pods"] - each * len(kinds)
    return counts


def _pick(r: np.random.Generator, values: Sequence, n: int) -> np.ndarray:
    return np.asarray(values)[r.integers(0, len(values), size=n)]


def backlog(traffic: Dict, seed: int, b: int) -> List[Dict]:
    """Backlog ``b`` of the pool: one row per pod with its kind, cohort,
    request shape and a fresh name, in an order of its own, as successive
    provisioning passes see it."""
    r = rng(seed, 1, b)
    n = traffic["pods"]
    kind = np.repeat(np.asarray(traffic["kinds"]), kind_counts(traffic))
    cpu = _pick(r, traffic["cpu_milli"], n)
    mem = _pick(r, traffic["memory_mib"], n)
    label = _pick(r, traffic.get("label_values", ["a"]), n)
    by_label = set(traffic.get("cohort_by_label", ()))
    one = set(traffic.get("one_cohort", ()))
    order = r.permutation(n)
    rows = []
    for j in order:
        k = str(kind[j])
        cohort = (f"{k}-{label[j]}" if k in by_label
                  else k if k in one else None)
        rows.append({"name": f"b{b}-p{int(j)}", "kind": k, "cohort": cohort,
                     "cpu": float(cpu[j]) / 1000.0,
                     "memory": float(mem[j]) * MIB})
    return rows


def _weighted(r: np.random.Generator, weights: Dict[str, float], n: int):
    values = np.asarray([float(v) for v in weights])
    p = np.asarray(list(weights.values()), dtype=np.float64)
    return values[r.choice(len(values), size=n, p=p / p.sum())]


def sweep_state(config: Dict, traffic: Dict, catalog: List[Dict], seed: int,
                s: int) -> Dict:
    """Cluster state ``s`` of the pool: the nodes in candidate-first order
    (candidates by disruption cost, then the rest) with what each has free,
    and each candidate's reschedulable pods."""
    r = rng(seed, 2, s)
    cl = config["cluster"]
    E, C, k = cl["nodes"], cl["candidates"], traffic["pods_per_candidate"]
    row = next(t for t in catalog if t["name"] == cl["node_type"])
    alloc = {"cpu": row["cpu"] - row["overhead"]["cpu"],
             "memory": row["memory"] - row["overhead"]["memory"],
             "pods": row["pods"]}
    cpu = _pick(r, traffic["pod_cpu_milli"], C * k)
    mem = _pick(r, traffic["pod_memory_mib"], C * k)
    cand_pods, nodes = [], []
    zones = row["zones"]
    for c in range(C):
        pods = [{"name": f"s{s}-c{c}-p{j}",
                 "cpu": float(cpu[c * k + j]) / 1000.0,
                 "memory": float(mem[c * k + j]) * MIB} for j in range(k)]
        cand_pods.append(pods)
        nodes.append({
            "name": f"s{s}-n{c}", "zone": zones[c % len(zones)],
            "available": {"cpu": alloc["cpu"] - sum(p["cpu"] for p in pods),
                          "memory": alloc["memory"]
                          - sum(p["memory"] for p in pods),
                          "pods": alloc["pods"] - k},
        })
    fcpu = _weighted(r, traffic["keep_free_cpu_milli"], E - C) / 1000.0
    fmem = _weighted(r, traffic["keep_free_memory_mib"], E - C) * MIB
    for i in range(E - C):
        n = C + i
        nodes.append({
            "name": f"s{s}-n{n}", "zone": zones[n % len(zones)],
            "available": {"cpu": float(fcpu[i]), "memory": float(fmem[i]),
                          "pods": alloc["pods"] - traffic["keep_used_pods"]},
        })
    return {"nodes": nodes, "candidate_pods": cand_pods,
            "node_type": row, "node_os": cl["node_os"],
            "capacity": {"cpu": row["cpu"], "memory": row["memory"],
                         "pods": row["pods"]}}
