"""Cells, configurations, traffic mixes and per-layer metrics are files of
their own that the harness finds by name; BENCHMARK.json keeps to the
contract's format."""
import hashlib
import json
import re
from pathlib import Path

from kbench import tiny

KB = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name_with_no_file_edited(tmp_path):
    root = tiny.make_root(tmp_path)
    kb = root / "kbench"
    before = _digest(kb)
    cfg = json.loads((kb / "configs/fake-400t.json").read_text())
    cfg["name"] = "dummy-cfg"
    cfg["catalog"]["types"] = 64
    (kb / "configs/dummy-cfg.json").write_text(json.dumps(cfg))
    t = json.loads((kb / "traffic/tiny-generic.json").read_text())
    t.update(pods=60, cpu_milli=[100, 200], memory_mib=[256])
    (kb / "traffic/dummy-mix.json").write_text(json.dumps(t))
    (kb / "metrics/dummy_calls.provision.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-cfg", "source": "test",
                             "file": "kbench/configs/dummy-cfg.json",
                             "reduced": [], "why": "test"})
    name = "dummy-cfg.dummy-mix"
    bench["workloads"].append({"name": name, "config": "dummy-cfg",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pods_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(name)
    bench["per_layer"].append({
        "name": "dummy_calls.provision", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "solve driver",
        "moves": "pods_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = tiny.run(root, name, seconds=0.5)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    traced = tiny.run(root, name, seconds=0.5, trace=True)
    assert traced["metrics"]["dummy_calls.provision"]["value"] >= 1
    # device metrics are not read off a CPU run
    assert not any(k.startswith(("ffd_roofline", "device_idle"))
                   for k in traced["metrics"])
    after = _digest(kb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_the_format():
    bench = json.loads((KB.parent / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["kbench"]
    configs = {c["name"] for c in bench["configs"]}
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert (KB.parent / c["file"]).exists()
        assert json.loads((KB.parent / c["file"]).read_text())["name"] == (
            c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (KB / "traffic" / f"{w['traffic']}.json").exists()
        names.add(w["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (KB / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
