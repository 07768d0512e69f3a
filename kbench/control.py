"""Run the control (``reference/control.py``) at a cell's own size:

    python3 kbench/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed (and, for a solve cell, a guarantee broken) with the
numbers the cell's check compares, read as the check reads them. For a
solve cell it also reads two faults planted in the reference put in the
program's place: every pod on a NodeClaim of its own (``one_per_claim``)
and every NodeClaim left with its costliest type (``costliest``). Plain
NumPy: it needs no card, and the benchmark's own runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

KBENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(KBENCH.parent))

from kbench.lib import catalog as kcat  # noqa: E402
from kbench.lib import gen  # noqa: E402
from kbench.reference import check, control, pack, sweep  # noqa: E402
from kbench.reference import units  # noqa: E402


def faulted(ref: dict, catalog: list, fault: str) -> dict:
    """The reference's answer with one fault planted."""
    price = units.cheapest_price(catalog)
    index = {t["name"]: i for i, t in enumerate(catalog)}
    claims = []
    for c in ref["claims"]:
        if fault == "one_per_claim":
            claims += [dict(c, pods=[p]) for p in c["pods"]]
        else:  # costliest
            top = max(c["options"], key=lambda o: price[index[o]])
            claims.append(dict(c, options=[top]))
    return dict(ref, claims=claims)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((KBENCH.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = json.loads((KBENCH / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = json.loads((KBENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    rows = kcat.catalog_rows(config["catalog"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if traffic["entry"] == "sweep":
            slots = config["cluster"]["max_slots"]
            wrong, err = 0, 0.0
            for s in range(traffic["states"]):
                st = gen.sweep_state(config, traffic, rows, seed, s)
                want = sweep.verdicts(st, rows, slots)
                got = control.sweep(st, rows, slots)
                wrong += sum(g[:2] != w[:2] for g, w in zip(got, want))
                err = max([err] + [abs(g[2] - w[2]) / w[2]
                                   for g, w in zip(got, want) if w[2] > 0])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "broken": "memory", "verdicts_wrong": wrong,
                              "price_rel_err": err}), flush=True)
            continue
        pods = gen.backlog(traffic, seed, 0)
        ref = pack.pack(pods, rows, traffic)
        answers = {b: control.solve(pods, rows, traffic, b)
                   for b in control.BROKEN}
        answers.update({f: faulted(ref, rows, f)
                        for f in ("one_per_claim", "costliest")})
        for broken, answer in answers.items():
            got = check.check(pods, rows, traffic, answer)
            got["nodeclaims_ratio"] = got["nodeclaims"] / len(ref["claims"])
            got["price_ratio"] = got["price"] / ref["price"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "broken": broken, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
