"""The generator: deterministic for a seed, different between seeds and
between the backlogs of one run, and drawing from the traffic's lists;
the catalog restates upstream's ``fake.InstanceTypes(n)``."""
import json
from collections import Counter
from pathlib import Path

import pytest

from kbench.lib import catalog, gen, port

KB = Path(__file__).resolve().parent


def _load(kind, name):
    return json.loads((KB / kind / f"{name}.json").read_text())


def _classes(rows):
    return Counter((r["kind"], r["cohort"], r["cpu"], r["memory"])
                   for r in rows)


def test_backlog_is_deterministic_and_seeded():
    t = _load("traffic", "diverse-5k")
    a, b = gen.backlog(t, 2**31 + 5, 1), gen.backlog(t, 2**31 + 5, 1)
    assert a == b
    c = gen.backlog(t, 2**31 + 6, 1)
    assert _classes(a) != _classes(c)
    assert len(a) == t["pods"]
    assert Counter(r["kind"] for r in a) == Counter(
        dict(zip(t["kinds"], gen.kind_counts(t))))
    assert gen.kind_counts(t) == [835] + [833] * 5


def test_backlogs_of_a_pool_have_fresh_names_and_classes_of_their_own():
    t = _load("traffic", "diverse-5k")
    b0, b1 = gen.backlog(t, 7, 0), gen.backlog(t, 7, 1)
    assert not {r["name"] for r in b0} & {r["name"] for r in b1}
    assert _classes(b0) != _classes(b1)
    assert {r["cohort"] for r in b0 if r["kind"] == "anti"} == {"anti"}
    assert len({r["cohort"] for r in b0 if r["kind"] == "host_spread"}) == 7
    assert {r["cpu"] for r in b0} == {x / 1000 for x in t["cpu_milli"]}


def test_generic_mix_draws_from_192_shapes():
    t = _load("traffic", "generic-50k")
    rows = gen.backlog(t, 3, 0)
    shapes = {(r["cpu"], r["memory"]) for r in rows}
    assert len(shapes) == 192
    assert {r["kind"] for r in rows} == {"generic"}
    assert _classes(rows) != _classes(gen.backlog(t, 3, 1))


def test_sweep_state_is_deterministic_and_seeded():
    cfg, t = _load("configs", "consol-5k"), _load("traffic", "sweep")
    cat = catalog.catalog_rows(cfg["catalog"])
    a = gen.sweep_state(cfg, t, cat, 2**33 + 1, 2)
    assert a == gen.sweep_state(cfg, t, cat, 2**33 + 1, 2)
    b = gen.sweep_state(cfg, t, cat, 2**33 + 2, 2)
    assert a["nodes"] != b["nodes"]
    assert len(a["nodes"]) == cfg["cluster"]["nodes"]
    assert [len(p) for p in a["candidate_pods"]] == (
        [t["pods_per_candidate"]] * cfg["cluster"]["candidates"])
    free = {n["available"]["cpu"] * 1000
            for n in a["nodes"][cfg["cluster"]["candidates"]:]}
    assert free == {float(v) for v in t["keep_free_cpu_milli"]}


@pytest.mark.parametrize("i,cpu,gib,pods", [(0, 1, 2, 10), (7, 8, 16, 80),
                                            (399, 400, 800, 4000)])
def test_catalog_restates_fake_instance_types(i, cpu, gib, pods):
    cfg = _load("configs", "fake-400t")
    rows = catalog.catalog_rows(cfg["catalog"])
    assert len(rows) == 400
    r = rows[i]
    assert r["name"] == f"fake-it-{i}"
    assert (r["cpu"], r["memory"], r["pods"]) == (cpu, gib * 2.0**30, pods)
    price = 0.1 * cpu + 0.1 * gib * 2.0**30 / 1e9
    assert [o["price"] for o in r["offerings"]] == [price] * 5
    assert sorted(r["os"]) == ["darwin", "linux", "windows"]
    it = port.instance_types([r])[0]
    assert it.allocatable()["cpu"] == pytest.approx(cpu - 0.1)
    assert it.allocatable()["memory"] == gib * 2.0**30 - 10 * 2.0**20
    assert len(it.offerings) == 5
