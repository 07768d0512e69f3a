"""Well-known label / annotation / taint vocabulary.

API-surface compatible with the reference CRDs (reference:
pkg/apis/v1/labels.go:30-105, pkg/apis/v1/taints.go). These strings are the
closed-world vocabulary that the solver's mask tensors are built over
(SURVEY.md §2.2: "these become the vocabulary of the mask tensors").
"""
from __future__ import annotations

GROUP = "karpenter.sh"

# kubernetes.io well-known label keys
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"

ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# Framework-specific labels
NODEPOOL_LABEL_KEY = f"{GROUP}/nodepool"
NODE_INITIALIZED_LABEL_KEY = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL_KEY = f"{GROUP}/registered"
CAPACITY_TYPE_LABEL_KEY = f"{GROUP}/capacity-type"

# Network-topology hierarchy (ISSUE 20). Two optional levels below the
# kubernetes zone: a rack (one ICI/ToR domain) and a superpod (a group of
# racks behind one spine block). Offerings and existing nodes carry them;
# the solver lowers the hierarchy into a per-domain-pair hop matrix
# (ops/topoplan) and a rank-aware fill order (ops/ffd). Absent labels mean
# "topology unknown" and the subsystem stays fully disengaged.
LABEL_TOPOLOGY_RACK = f"topology.{GROUP}/rack"
LABEL_TOPOLOGY_SUPERPOD = f"topology.{GROUP}/superpod"

# Annotations
DO_NOT_DISRUPT_ANNOTATION_KEY = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION_KEY = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = f"{GROUP}/nodepool-hash-version"
# bumped whenever static_hash()'s algorithm/fields change; drift compares
# hashes only when versions match (hash/controller.go migration)
HASH_VERSION = "v3"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = (
    f"{GROUP}/nodeclaim-termination-timestamp"
)

# Finalizers
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Taint keys (reference: pkg/apis/v1/taints.go:26-41)
DISRUPTED_TAINT_KEY = f"{GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"

RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

LABEL_DOMAIN_EXCEPTIONS = frozenset(
    {"kops.k8s.io", "node.kubernetes.io", "node-restriction.kubernetes.io"}
)

# Labels the controller understands and can narrow through NodePools or pods
# (reference: pkg/apis/v1/labels.go:78-88).
WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL_KEY,
        LABEL_TOPOLOGY_ZONE,
        LABEL_TOPOLOGY_REGION,
        LABEL_INSTANCE_TYPE,
        LABEL_ARCH,
        LABEL_OS,
        CAPACITY_TYPE_LABEL_KEY,
        LABEL_WINDOWS_BUILD,
        LABEL_TOPOLOGY_RACK,
        LABEL_TOPOLOGY_SUPERPOD,
    }
)

RESTRICTED_LABELS = frozenset({LABEL_HOSTNAME})

# Aliased (deprecated) label keys translated into well-known ones
# (reference: pkg/apis/v1/labels.go:97-104).
NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": LABEL_TOPOLOGY_ZONE,
    "failure-domain.beta.kubernetes.io/region": LABEL_TOPOLOGY_REGION,
    "beta.kubernetes.io/arch": LABEL_ARCH,
    "beta.kubernetes.io/os": LABEL_OS,
    "beta.kubernetes.io/instance-type": LABEL_INSTANCE_TYPE,
}


def is_restricted_label(key: str) -> bool:
    """True if the label may not be user-set (reference labels.go:108-120)."""
    if key in WELL_KNOWN_LABELS:
        return False
    domain = label_domain(key)
    if any(domain == d or domain.endswith("." + d) for d in RESTRICTED_LABEL_DOMAINS):
        if domain in LABEL_DOMAIN_EXCEPTIONS or any(
            domain.endswith("." + d) for d in LABEL_DOMAIN_EXCEPTIONS
        ):
            return False
        return True
    return key in RESTRICTED_LABELS


def is_restricted_node_label(key: str) -> bool:
    """True if the label must not be injected by the framework: well-known
    labels (cloud provider injects those), restricted domains, hostname
    (reference labels.go:118-131)."""
    if key in WELL_KNOWN_LABELS:
        return True
    domain = label_domain(key)
    if any(domain == d or domain.endswith("." + d) for d in LABEL_DOMAIN_EXCEPTIONS):
        return False
    if any(domain == d or domain.endswith("." + d) for d in RESTRICTED_LABEL_DOMAINS):
        return True
    return key in RESTRICTED_LABELS


def label_domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""
