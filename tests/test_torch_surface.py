"""The port's operator surface: flags, the binary, logging, the health
server, the fake cloud provider and the CRD manifests.

tests/test_operator_surface.py, tests/test_cloudprovider.py and
tests/test_periphery.py are read onto the port (tests/torch_ported.py) and
their cases run on the port's copies, with the greedy solver. Beside them:
``Options.parse`` gives the JAX package's options on the same flags and
environment (less the kernel's name, which the port spells ``cuda |
reference``), the binary with ``--solver tpu`` raises without a GPU naming
``cuda``, the binary as a process answers its three health routes, the fake
provider's catalog equals the reference's, and the CRD manifests are the
reference's byte for byte.
"""
import dataclasses
from pathlib import Path

import pytest
import torch

import chip_smoke
from tests.torch_ported import ported

from karpenter_core_tpu.cloudprovider import fake as jfake
from karpenter_core_tpu.operator import Options as RefOptions
from karpenter_core_tpu_torch.cloudprovider import fake as pfake
from karpenter_core_tpu_torch.operator import Options

ROOT = Path(__file__).resolve().parents[1]

_surface = ported("test_operator_surface")
TestOptionsParse = _surface.TestOptionsParse
TestLogging = _surface.TestLogging
TestCLI = _surface.TestCLI
TestHydration = _surface.TestHydration
TestCloudProviderMetrics = _surface.TestCloudProviderMetrics
TestHealthProbes = _surface.TestHealthProbes
TestProfilingHook = _surface.TestProfilingHook
TestHealthServer = _surface.TestHealthServer

_cloud = ported("test_cloudprovider")
TestKwokCatalog = _cloud.TestKwokCatalog
TestMinValues = _cloud.TestMinValues
TestFakeProvider = _cloud.TestFakeProvider
TestBudgets = _cloud.TestBudgets

_periphery = ported("test_periphery")
TestLivenessTTL = _periphery.TestLivenessTTL
TestGarbageCollectionLeakedInstance = (
    _periphery.TestGarbageCollectionLeakedInstance)


class TestCrdArtifacts:
    """The schema case on the port's manifests (the generator case checks
    the reference's files against the reference's dataclasses)."""

    test_crd_schema_covers_spec_surface = (
        _periphery.TestCrdArtifacts.test_crd_schema_covers_spec_surface)

ARGVS = [
    [],
    ["--solver", "tpu", "--batch-max-duration=5",
     "--batch-idle-duration", "0.5", "--log-level=debug"],
    ["--feature-gates", "NodeRepair=true,SpotToSpot=false"],
    ["--solver", "tpu", "--solver-mode", "sidecar",
     "--solver-addr=127.0.0.1:8181", "--solver-timeout", "5"],
    ["--solver-tenant", "blue", "--solver-queue-depth=8",
     "--solver-tenant-weights", "blue=3,green=1"],
    ["--solver-fleet", "4", "--solver-wire=full"],
    ["--solver-addr", "h:1,h:2"],
    ["--poll-interval=2.5", "--max-iters", "7", "--health-port", "8081"],
    ["--profile-solves", "3", "--profile-dir", "/x"],
    ["--solver", "tpu", "--solver-devices", "0", "--solver-backend",
     "relax"],
]
ENVS = [
    {"KARPENTER_SOLVER": "tpu", "KARPENTER_BATCH_MAX_DURATION": "3"},
    {"KARPENTER_SOLVER": "tpu", "KARPENTER_SOLVER_MODE": "sidecar"},
    {"KARPENTER_SOLVER_TENANT": "green", "KARPENTER_SOLVER_FLEET": "2"},
]


def _fields(options):
    out = dataclasses.asdict(options)
    out.pop("solver_kernel")  # xla | pallas there, cuda | reference here
    return out


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_options_parse_equals_reference(argv):
    assert _fields(Options.parse(argv, env={})) == _fields(
        RefOptions.parse(argv, env={}))


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(sorted(e)))
def test_options_env_equals_reference(env):
    assert _fields(Options.parse([], env=env)) == _fields(
        RefOptions.parse([], env=env))


def test_kernel_flag_names_the_port_kernels():
    assert Options.parse([], env={}).solver_kernel == "cuda"
    assert Options.parse(["--kernel", "reference"],
                         env={}).solver_kernel == "reference"


def test_main_tpu_solver_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    from karpenter_core_tpu_torch.main import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--solver", "tpu", "--max-iters", "2", "--poll-interval",
              "0.01"])


def test_main_greedy_with_health_server():
    from karpenter_core_tpu_torch.main import main

    assert main(["--solver", "greedy", "--max-iters", "2",
                 "--poll-interval", "0.01", "--health-port", "-1"]) == 0


def test_binary_process_answers_health_routes():
    """The binary as a user starts it (the greedy solver here; chip_smoke.py
    phase 13 starts it with ``--solver tpu`` on the card)."""
    run = chip_smoke.binary_run("greedy")
    assert run["rc"] == 0 and not run["traceback"], run
    assert run["routes"] == {"/healthz": 200, "/readyz": 200,
                             "/metrics": 200}, run


def test_logging_levels_equal_reference():
    import logging as stdlib_logging

    from karpenter_core_tpu import logging as jlog
    from karpenter_core_tpu_torch import logging as plog

    for level in ("debug", "info", "warn", "error", "dpanic", "bogus"):
        assert plog.configure(level).level == jlog.configure(level).level
    assert not plog.nop_logger().isEnabledFor(stdlib_logging.CRITICAL)


@pytest.mark.parametrize("n", [1, 5, 12])
def test_fake_instance_types_equal_reference(n):
    def view(its):
        return [(it.name, sorted(it.capacity.items()), str(it.requirements),
                 [(o.price, o.available, str(o.requirements))
                  for o in it.offerings]) for it in its]

    assert view(pfake.fake_instance_types(n)) == view(
        jfake.fake_instance_types(n))


@pytest.mark.parametrize("name", ["karpenter.sh_nodeclaims.yaml",
                                  "karpenter.sh_nodepools.yaml"])
def test_crd_manifests_equal_reference(name):
    port = ROOT / "karpenter_core_tpu_torch" / "api" / "crds" / name
    ref = ROOT / "karpenter_core_tpu" / "api" / "crds" / name
    assert port.read_bytes() == ref.read_bytes()
