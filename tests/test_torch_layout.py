"""Layout rules of the PyTorch port.

* No module of the port, and not chip_smoke.py or bench_torch.py, imports
  JAX or anything of the JAX package, nor bench.py or fleet_expected.py
  (which drive it): an AST scan of every import statement, including the
  ones inside functions.
* The host-side modules copied from the JAX package equal their sources
  byte for byte once the package name is rewritten (read as text, never
  imported here).
* The device policy: CUDA by default, no fallback to the CPU.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "karpenter_core_tpu_torch"
REF = ROOT / "karpenter_core_tpu"

COPIED = [
    "api/__init__", "api/duration", "api/labels", "api/nodeclaim",
    "api/nodepool", "api/objects", "api/status",
    "utils/__init__", "utils/clock", "utils/cron", "utils/disruption",
    "utils/resources", "utils/timesource",
    "scheduling/__init__", "scheduling/requirement",
    "scheduling/requirements", "scheduling/taints",
    "scheduling/volumeusage",
    "cloudprovider/__init__", "cloudprovider/types", "cloudprovider/kwok",
    "cloudprovider/unavailableofferings",
    "metrics/__init__", "metrics/registry", "metrics/wiring",
    "events/__init__", "events/recorder",
    "controllers/__init__", "controllers/provisioning/__init__",
    "controllers/provisioning/scheduling/__init__",
    "controllers/provisioning/scheduling/hostports",
    "controllers/provisioning/scheduling/inflight",
    "controllers/provisioning/scheduling/nodeclaimtemplate",
    "controllers/provisioning/scheduling/preferences",
    "controllers/provisioning/scheduling/queue",
    "controllers/provisioning/scheduling/scheduler",
    "controllers/provisioning/scheduling/topology",
    "solver/__init__", "solver/vocab", "solver/gangs", "solver/snapshot",
    "solver/verify",
    "ops/__init__", "ops/topoplan",
    # the operator's import closure (slice 4)
    "utils/pod", "utils/pdb",
    "kube/__init__", "kube/serial", "kube/store",
    "state/__init__", "state/cluster",
    "cloudprovider/metrics",
    "controllers/provisioning/scheduling/volumetopology",
    "controllers/provisioning/batcher",
    "controllers/nodeclaim/__init__", "controllers/nodeclaim/disruption",
    "controllers/nodeclaim/gc", "controllers/nodeclaim/hydration",
    "controllers/nodeclaim/lifecycle",
    "controllers/node/__init__", "controllers/node/health",
    "controllers/node/termination",
    "controllers/nodepool/__init__", "controllers/nodepool/controllers",
    "controllers/status",
    "controllers/disruption/__init__", "controllers/disruption/types",
    "controllers/disruption/helpers", "controllers/disruption/validation",
    "controllers/disruption/controller", "controllers/disruption/methods",
    "solver/fleet",
    # solverd and its incremental engine (slice 6)
    "solver/codec", "solver/segments", "solver/autoscale",
    "solver/incremental", "kube/httpserver",
    # the operator's binary, the HTTP kube client, chaos and the twin
    # (slice 7); main.py and twin/harness.py are edited copies
    "logging", "healthserver", "kube/client", "kube/httpclient",
    "cloudprovider/fake", "chaos", "api/crds/__init__", "utils/lockorder",
    "twin/__init__", "twin/clock", "twin/scenario", "twin/workloads",
    "twin/ledger", "twin/invariants", "twin/shrink",
    # the sidecar client, with its greedy degradation
    "solver/remote",
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "karpenter_core_tpu", "bench",
                   "fleet_expected")


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "bench_torch.py"]
    return [f for f in files if "build" not in f.relative_to(ROOT).parts]


def test_port_sources_exist():
    names = {str(f.relative_to(ROOT)) for f in _port_sources()}
    for required in (
        "chip_smoke.py",
        "bench_torch.py",
        "karpenter_core_tpu_torch/interop.py",
        "karpenter_core_tpu_torch/utils/device.py",
        "karpenter_core_tpu_torch/ops/ffd.py",
        "karpenter_core_tpu_torch/ops/masks.py",
        "karpenter_core_tpu_torch/ops/cuda_ffd.py",
        "karpenter_core_tpu_torch/models/provisioner.py",
        "karpenter_core_tpu_torch/models/consolidation.py",
        "karpenter_core_tpu_torch/operator.py",
        "karpenter_core_tpu_torch/controllers/provisioning/provisioner.py",
        "karpenter_core_tpu_torch/ops/relax.py",
        "karpenter_core_tpu_torch/solver/service.py",
        "karpenter_core_tpu_torch/solver/supervisor.py",
        "karpenter_core_tpu_torch/solver/remote.py",
        "karpenter_core_tpu_torch/main.py",
        "karpenter_core_tpu_torch/twin/harness.py",
        "karpenter_core_tpu_torch/parallel/__init__.py",
        "karpenter_core_tpu_torch/parallel/mesh.py",
    ):
        assert required in names, required
    assert (PORT / "csrc" / "ffd_step.cu").is_file()


def _rewritten(module: str) -> str:
    return re.sub(r"\bkarpenter_core_tpu\b", "karpenter_core_tpu_torch",
                  (REF / f"{module}.py").read_text())


def _body(text: str) -> str:
    """A module's text after its docstring."""
    return text.split('"""', 2)[2]


def test_main_differs_from_its_source_only_in_its_docstring():
    """Apart from its docstring, main.py differs from its source only in
    the crash-only exit after a sticky CUDA error: the lines it replaces
    are the teardown and the two exits, and nothing it adds reaches a host
    solver or a CPU fallback."""
    import difflib

    diff = list(difflib.ndiff(_body(_rewritten("main")).splitlines(),
                              _body((PORT / "main.py").read_text())
                              .splitlines()))
    removed = [ln[2:].strip() for ln in diff if ln.startswith("- ")]
    assert removed == ["op.shutdown()", "return 0", "sys.exit(main())"]
    added = "\n".join(ln[2:].split("#")[0] for ln in diff
                      if ln.startswith("+ "))
    assert "DEVICE_FAULT_EXIT_CODE" in added and "device_fault" in added
    for token in ("Scheduler(", "greedy", "fallback", '"cpu"'):
        assert token not in added, token


def test_crd_manifests_are_copied():
    for name in ("karpenter.sh_nodeclaims.yaml",
                 "karpenter.sh_nodepools.yaml"):
        assert (PORT / "api" / "crds" / name).read_bytes() == (
            REF / "api" / "crds" / name).read_bytes()


def test_twin_harness_edits_are_the_device_and_the_failure_counter():
    """twin/harness.py is an edited copy: apart from its docstring, the
    lines it changes are the two constructors and the two places that
    build a solver (they gain the device and kernel), and what it adds
    threads those or counts failed RPCs, never a host solver."""
    import difflib

    port = _body((PORT / "twin" / "harness.py").read_text()).splitlines()
    # the copy drops the reference's issue tags from its comments
    ref = re.sub(r" \(ISSUE \d+\)|, ISSUE \d+(?=\))", "",
                 _body(_rewritten("twin/harness"))).splitlines()
    diff = list(difflib.ndiff(ref, port))
    removed = [ln[2:].strip() for ln in diff if ln.startswith("- ")]
    assert removed == [
        "def __init__(self, n: int, vclock: VirtualClock):",
        "def __init__(self, scenario: Scenario, reconcile_iters: int = 300):",
        "options = Options(solver=s.solver)",
        "tier = _FleetTier(s.fleet, vclock) if s.fleet else None",
    ]
    added = "\n".join(ln[2:].split("#")[0] for ln in diff
                      if ln.startswith("+ "))
    for token in ("Scheduler(", "greedy", "fallback", "FALLBACK"):
        assert token not in added, token


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_source(module):
    assert (PORT / f"{module}.py").read_text() == _rewritten(module)


def test_device_policy():
    from karpenter_core_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
    from karpenter_core_tpu_torch.api.objects import ObjectMeta
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec = NodePoolSpec()
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceScheduler([pool], {"default": build_catalog()[:4]})


def test_source_digest_covers_the_bench():
    """chip_smoke.source_digest() ties a run to a tree: this script, the
    port's bench and every Python and CUDA source of the package."""
    import chip_smoke

    digest, n_files = chip_smoke.source_digest()
    pkg = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")
           and "build" not in p.relative_to(ROOT).parts]
    assert n_files == len(pkg) + 2 and len(digest) == 64
