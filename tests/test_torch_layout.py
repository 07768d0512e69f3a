"""Layout rules of the PyTorch port.

* No module of the port, and not chip_smoke.py, imports JAX or anything of
  the JAX package (an AST scan of every import statement, including the
  ones inside functions).
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
    return top in ("jax", "jaxlib", "karpenter_core_tpu")


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if "build" not in f.relative_to(ROOT).parts]


def test_port_sources_exist():
    names = {str(f.relative_to(ROOT)) for f in _port_sources()}
    for required in (
        "chip_smoke.py",
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
    ):
        assert required in names, required
    assert (PORT / "csrc" / "ffd_step.cu").is_file()


def test_sidecar_client_has_no_host_solver():
    """solver/remote.py is an edited copy: a sidecar solve or sweep
    without a verified answer raises, and nothing in the client reaches a
    host solver (the reference re-solves on the greedy Scheduler)."""
    src = (PORT / "solver" / "remote.py").read_text()
    ref = (REF / "solver" / "remote.py").read_text()
    assert "_fallback_solve" in ref and "degraded_solve" in ref
    for token in ("_fallback_solve", "degraded_solve", "Scheduler(",
                  "SOLVER_RPC_FALLBACKS.inc"):
        assert token not in src, token


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_source(module):
    src = (REF / f"{module}.py").read_text()
    expected = re.sub(r"\bkarpenter_core_tpu\b", "karpenter_core_tpu_torch",
                      src)
    assert (PORT / f"{module}.py").read_text() == expected


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
