"""Nothing the benchmark runs imports JAX, the JAX package or the repo's
older benches, compared by whole top-level module names (the port's name
begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

KB = Path(__file__).resolve().parent
NEVER = {"jax", "jaxlib", "flax", "karpenter_core_tpu"}
# what the benchmark's runs must not load; its tests may hold the frozen
# arithmetic to the smoke's
NOT_RUN = NEVER | {"bench", "bench_torch", "chip_smoke"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in KB.rglob("*.py"):
        tests = path.name.startswith(("test_", "conftest"))
        bad = set(_imports(path)) & (NEVER if tests else NOT_RUN)
        assert not bad, (path, bad)


def test_names_compare_whole():
    sys.path.insert(0, str(KB))
    import run

    assert "karpenter_core_tpu_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == NEVER


def test_a_run_loads_none_of_them(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(KB.parent)!r})
from pathlib import Path
from kbench import tiny
root = tiny.make_root(Path({str(tmp_path)!r}))
out = tiny.run(root, tiny.GENERIC, seconds=0.5)
assert out["correct"], out
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(NOT_RUN)!r})))
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin"})
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
