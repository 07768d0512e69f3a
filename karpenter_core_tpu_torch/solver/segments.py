"""segmentstore: content-addressed solve-request segments (the delta wire).

Every sidecar solve used to re-encode and ship the FULL problem across the
gRPC/DCN boundary; at production snapshot sizes the encode+wire+decode of
an essentially unchanged cluster dominates the RPC and defeats the
fingerprint-keyed caches across the hop. This module turns a solve request
into a *manifest* of content-addressed segments:

* the v5 wire splits a solve header into canonically-encoded segments —
  nodepool/template tables, the instance-type catalog, existing-node
  views (hash-bucketed by node name so 1% node churn re-ships ~1% of node
  bytes, not a positional avalanche), daemonset pods, topology context
  (domains + node-bucketed existing-pod triples), and per-class pending
  pod batches (grouped by a spec key that strips pod identity, so a
  deployment's worth of identical pods is one segment) — each segment's
  sha256 over its canonical JSON bytes IS its wire identity (PR 4 made
  every encoder canonical per logical content, which is what makes the
  digests stable across operators, restarts, and relist order);
* the client sends digests; the sidecar answers a TYPED miss
  (``need: [digests]``, HTTP 409) for anything its ``SegmentStore`` does
  not hold; the client uploads exactly those and retries once — a
  respawned sidecar costs one re-upload round, never a wrong solve and
  never a greedy fallback (solver/remote.py treats the miss as
  degradation-not-fault, mirroring the PR 5 shed/drain contract);
* ``problem_fingerprint`` is derived from the manifest's problem-half
  segment digests, so the full-wire and manifest paths key the SAME
  cached DeviceScheduler, and the prepared-state caches hit across
  restarts of either side;
* ``SegmentStore`` (daemon side) is TTL'd and LRU-bounded in entries AND
  bytes, with eviction metrics, so N tenants' snapshots cannot grow the
  sidecar without bound; ``SentCache`` (client side) remembers which
  digests a given sidecar INSTANCE has confirmed, so an unchanged catalog
  never re-uploads — and a respawned instance (fresh id on the response
  header) invalidates exactly that member's sent-set.

The manifest/inline FIELD SETS are frozen in the GL403 wire-schema lock
via solver/codec.py (``encode_manifest_request`` / ``_encode_manifest_
inline``); this module owns the splitting, digests, and stores — no new
wire field is ever minted here.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

# segment kinds on the manifest listing; "nodes"/"topo_pods"/"pods" may
# appear many times (bucketed / per-class batches), the rest exactly once
KIND_NODEPOOLS = "nodepools"
KIND_CATALOG = "catalog"
KIND_NODES = "nodes"
KIND_DSPODS = "dspods"
KIND_TOPO_DOMAINS = "topo_domains"
KIND_TOPO_PODS = "topo_pods"
KIND_PODS = "pods"
SEGMENT_KINDS = (
    KIND_NODEPOOLS, KIND_CATALOG, KIND_NODES, KIND_DSPODS,
    KIND_TOPO_DOMAINS, KIND_TOPO_PODS, KIND_PODS,
)
# canonical listing order: rows sort by (kind rank, digest), which makes
# the listing itself content-addressed — the SAME problem always yields
# the SAME listing bytes, so a manifest can name its previous listing by
# digest and ship only the row edits (the steady-state delta wire's
# biggest win: hundreds of unchanged digests stop riding every request)
_KIND_RANK = {k: i for i, k in enumerate(SEGMENT_KINDS)}

# bucket sizing: mean entities per hash bucket. Small buckets keep the
# churn amplification low (a changed entity re-ships ~target neighbors,
# so the re-shipped fraction at churn c is ~c x target) at the cost of
# more manifest digests; the node target is the aggressive one because
# existing-node views dominate production snapshots.
NODE_BUCKET_TARGET = 4
TOPO_POD_BUCKET_TARGET = 8
_MAX_BUCKETS = 4096
# pending-pod batches: spec-key grouping keeps a deployment's replicas in
# one segment, but a diverse pod mix would shatter into per-pod batches
# whose tiny compression windows cost more than they save — spec keys
# hash-fold into at most this many batches (identical specs still always
# share one)
POD_BATCH_CAP = 32

# daemon-side store bounds (solverd --segment-cache-mib/--segment-ttl
# override). The TTL is idle-based: a segment re-referenced by any
# manifest stays resident, one no manifest names for a full TTL expires
# even if the store never fills.
DEFAULT_STORE_BYTES = 256 << 20
DEFAULT_STORE_ENTRIES = 1 << 16
DEFAULT_STORE_TTL = 3600.0

# client-side sent-cache bound (digests per sidecar instance)
DEFAULT_SENT_DIGESTS = 1 << 16

# pod metadata fields stripped when grouping pending pods into per-class
# batches: identity only — everything that makes two replicas of one
# deployment DIFFERENT pods, nothing that changes where they can schedule
_POD_IDENTITY_FIELDS = (
    "name", "uid", "resource_version", "creation_timestamp", "generation",
)


class SegmentMissError(Exception):
    """The daemon cannot assemble a manifest: ``need`` names the segment
    digests its store does not hold. The HTTP layer answers 409 with the
    list (+ the daemon's instance id) and the client uploads exactly
    those — a typed miss, never a wrong solve."""

    def __init__(self, need: List[str]):
        super().__init__(f"missing {len(need)} segment(s)")
        self.need = list(need)


def canonical_bytes(value) -> bytes:
    """The segment encoding: compact JSON with recursively sorted keys —
    one byte string per logical value regardless of host dict order (list
    order IS content; every list in the solve header is already canonical
    per PR 4's encoder sweep)."""
    return json.dumps(
        value, sort_keys=True, separators=(",", ":")
    ).encode()


# segment digests are sha256 truncated to 24 hex chars (96 bits): digest
# rows ride EVERY manifest (and hex is incompressible), so length is wire
# cost — 96 bits keeps accidental collisions out of reach (~2^48 birthday
# over a store that holds ~2^16 entries) and an adversarial collision
# still cannot corrupt a solve silently: the upload site verifies content
# against the digest, and the CLIENT-side ResultVerifier independently
# re-checks every packing, so the worst case is a verification reject +
# greedy degradation, never a wrong bind. Full-body quarantine digests
# (codec.request_digest) stay full sha256.
DIGEST_HEX = 24


def digest_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:DIGEST_HEX]


def _bucket_count(n: int, target: int) -> int:
    """Power-of-two bucket count for ~``target`` entities per bucket.
    Pow2 so the count (and therefore every unchanged entity's bucket
    membership) is stable until the population roughly doubles."""
    if n <= target:
        return 1
    return min(_MAX_BUCKETS, 1 << ((n + target - 1) // target - 1).bit_length())


def _bucket_of(name: str, n_buckets: int) -> int:
    if n_buckets <= 1:
        return 0
    h = hashlib.sha256(name.encode()).digest()
    return int.from_bytes(h[:4], "big") % n_buckets


def _enc_pod_sort_key(enc) -> Tuple[str, str, str]:
    """codec._pod_sort_key over an already-serialized pod dict."""
    md = enc.get("metadata") if isinstance(enc, dict) else None
    md = md if isinstance(md, dict) else {}
    return (
        md.get("namespace") or "", md.get("name") or "", md.get("uid") or ""
    )


def _topo_sort_key(triple) -> tuple:
    """codec._encode_topology's canonical (node, pod) order, recomputed
    from the encoded triple so bucket reassembly reproduces the exact
    full-wire list."""
    return (triple[2], _enc_pod_sort_key(triple[0]))


def _pod_spec_key(enc: dict) -> str:
    """Per-class grouping key for pending pods: the serialized pod with
    identity metadata stripped. Replicas of one deployment share a key,
    so their batch segment is stable while only membership churns."""
    if isinstance(enc, dict) and isinstance(enc.get("metadata"), dict):
        md = {
            k: v
            for k, v in enc["metadata"].items()
            if k not in _POD_IDENTITY_FIELDS
        }
        enc = {**enc, "metadata": md}
    return digest_of(canonical_bytes(enc))[:16]


class SegmentPlan:
    """One solve header split into content-addressed segments.

    ``listing`` is the manifest's ``[kind, digest]`` rows in canonical
    order; ``segments`` maps digest -> canonical bytes; ``inline`` is the
    non-addressed remainder (codec._encode_manifest_inline — the pod-half
    scalars plus presence flags); ``pod_batch``/``pod_member`` rebuild
    the caller's exact pending-pod order from the per-class batches.
    ``fingerprint`` is the digest-derived problem fingerprint (equal to
    codec.problem_fingerprint of the same header by construction) and
    ``core_digest`` the quarantine/poison key — stable whether or not
    segment uploads ride along with the manifest."""

    __slots__ = (
        "listing", "segments", "inline", "pod_batch", "pod_member",
        "catalog_digest", "fingerprint", "core_digest", "listing_digest",
    )

    def __init__(self, listing, segments, inline, pod_batch, pod_member,
                 catalog_digest):
        self.listing = listing
        self.segments = segments
        self.inline = inline
        self.pod_batch = pod_batch
        self.pod_member = pod_member
        self.catalog_digest = catalog_digest
        self.fingerprint = fingerprint_of_parts(listing, inline)
        self.core_digest = core_digest_of(
            listing, inline, pod_batch, pod_member
        )
        # the listing's own content address: what a follow-up manifest
        # names as its base to ship row EDITS instead of every digest
        self.listing_digest = listing_digest_of(listing)

    def all_digests(self) -> List[str]:
        return list(self.segments)

    def raw_bytes(self, digests=None) -> int:
        ds = self.segments if digests is None else digests
        return sum(len(self.segments[d]) for d in ds if d in self.segments)


def _problem_listing(header: dict, keep: Optional[Dict[str, bytes]]):
    """The PROBLEM-half listing (everything the fingerprint hashes).
    ``keep`` collects digest -> bytes when the caller needs the segment
    data (the client split); None computes digests only (the full-wire
    fingerprint path)."""
    listing: List[List[str]] = []

    def add(kind: str, value) -> str:
        data = canonical_bytes(value)
        dg = digest_of(data)
        if keep is not None:
            keep[dg] = data
        listing.append([kind, dg])
        return dg

    add(KIND_NODEPOOLS, header["nodepools"])
    catalog_digest = add(
        KIND_CATALOG,
        {"it_table": header["it_table"], "it_pools": header["it_pools"]},
    )
    nodes = header["existing_nodes"]
    nb = _bucket_count(len(nodes), NODE_BUCKET_TARGET)
    node_buckets: List[list] = [[] for _ in range(nb)]
    for nd in nodes:
        node_buckets[_bucket_of(nd["name"], nb)].append(nd)
    for bucket in node_buckets:
        if bucket:  # empty buckets carry nothing and would only dup digests
            add(KIND_NODES, bucket)
    add(KIND_DSPODS, header["daemonset_pods"])
    topo = header.get("topology")
    if topo is not None:
        add(KIND_TOPO_DOMAINS, topo["domains"])
        tpods = topo["existing_pods"]
        tb = _bucket_count(len(tpods), TOPO_POD_BUCKET_TARGET)
        topo_buckets: List[list] = [[] for _ in range(tb)]
        for triple in tpods:
            topo_buckets[_bucket_of(str(triple[2]), tb)].append(triple)
        for bucket in topo_buckets:
            if bucket:
                add(KIND_TOPO_PODS, bucket)
    return listing, catalog_digest, add


def sort_listing(rows) -> List[List[str]]:
    """The canonical listing order: (kind rank, digest). Both sides sort
    with THIS, so a listing reconstructed from base+edits is row-for-row
    the client's — which the pod layout arrays (indices into the pods
    rows) depend on."""
    return sorted(
        ([str(k), str(d)] for k, d in rows),
        key=lambda r: (_KIND_RANK.get(r[0], len(_KIND_RANK)), r[1]),
    )


def listing_bytes(rows) -> bytes:
    return canonical_bytes(sort_listing(rows))


def listing_digest_of(rows) -> str:
    return digest_of(listing_bytes(rows))


def split_solve_header(header: dict) -> SegmentPlan:
    """Split a full solve header (codec._encode_solve_header's dict) into
    a SegmentPlan. The inverse is ``assemble_solve_header``; the pair is
    exact — assembly reproduces the original header value-for-value, so
    manifest-path solves are wire-identical to full-path ones. The
    listing comes back canonically sorted (sort_listing), making it
    content-addressed for the base+edits manifest form."""
    from karpenter_core_tpu_torch.solver import codec

    segments: Dict[str, bytes] = {}
    rows, catalog_digest, add = _problem_listing(header, segments)

    # pending pods: per-class batches (spec key strips identity, keys
    # hash-fold to at most POD_BATCH_CAP batches), members canonically
    # ordered within each batch; the layout arrays rebuild the caller's
    # exact queue order on the far side
    pods_enc = header["pods"]
    # ~8 pods per batch, capped: small pending sets stay in a few
    # well-compressing segments instead of shattering per-pod
    nb = min(POD_BATCH_CAP, max(len(pods_enc) // 8, 1))
    by_bucket: Dict[int, List[int]] = {}
    for i, enc in enumerate(pods_enc):
        by_bucket.setdefault(
            _bucket_of(_pod_spec_key(enc), nb), []
        ).append(i)
    pod_batch = [0] * len(pods_enc)
    pod_member = [0] * len(pods_enc)
    placed: Dict[str, List[tuple]] = {}  # batch digest -> [(i, m), ...]
    for bucket in by_bucket.values():
        order = sorted(
            bucket, key=lambda i: _enc_pod_sort_key(pods_enc[i])
        )
        dg = add(KIND_PODS, [pods_enc[i] for i in order])
        placed[dg] = [(i, m) for m, i in enumerate(order)]

    # canonical row order; pods batch indices follow the SORTED order so
    # the daemon's reconstruction (which only ever sees sorted rows)
    # indexes identically
    listing = sort_listing(rows)
    batch_index = {
        dg: b
        for b, dg in enumerate(
            dg for kind, dg in listing if kind == KIND_PODS
        )
    }
    for dg, members in placed.items():
        for i, m in members:
            pod_batch[i] = batch_index[dg]
            pod_member[i] = m

    return SegmentPlan(
        listing, segments, codec._encode_manifest_inline(header),
        pod_batch, pod_member, catalog_digest,
    )


def fingerprint_of_header(header: dict) -> str:
    """codec.problem_fingerprint's v5 implementation: the digest-derived
    fingerprint computed from a FULL header (the manifest path computes
    the identical value from its listing without reassembling)."""
    from karpenter_core_tpu_torch.solver import codec

    listing, _catalog, _add = _problem_listing(header, None)
    return fingerprint_of_parts(
        listing, codec._encode_manifest_inline(header)
    )


def fingerprint_of_parts(listing, inline) -> str:
    """The problem fingerprint from manifest parts alone: the sorted
    problem-half (kind, digest) pairs plus the problem-half inline
    scalars. Pod batches, the pod layout, tenant, solver_mode, and the
    pod-derived topology exclusions are all pod-half — excluded exactly
    as the v4 JSON-hash fingerprint excluded them, so the scheduler cache
    keeps its churn profile while becoming derivable from digests."""
    from karpenter_core_tpu_torch.solver import codec

    probe = {
        "version": codec.SOLVE_WIRE_VERSION,
        "segments": sorted(
            [str(k), str(d)] for k, d in listing if k != KIND_PODS
        ),
        "max_slots": inline.get("max_slots"),
        "unavailable_offerings": inline.get("unavailable_offerings"),
        "has_topology": bool(inline.get("has_topology")),
    }
    return digest_of(canonical_bytes(probe))


def core_digest_of(listing, inline, pod_batch, pod_member) -> str:
    """The quarantine/poison key of a manifest request: digests + inline
    + pod layout — the request's CONTENT, independent of which segment
    uploads happen to ride along, so the strike ledger sees one key per
    logical problem across the miss/re-upload handshake."""
    from karpenter_core_tpu_torch.solver import codec

    probe = {
        "version": codec.SOLVE_WIRE_VERSION,
        "segments": [[str(k), str(d)] for k, d in listing],
        "inline": inline,
        "pod_batch": [int(x) for x in pod_batch],
        "pod_member": [int(x) for x in pod_member],
    }
    return digest_of(canonical_bytes(probe))


def check_manifest_parts(listing, inline) -> None:
    """Decode-net validation of a manifest's listing + inline shapes: a
    malformed manifest must be a ValueError (the client's decode-failure
    degradation), never a TypeError three layers into assembly."""
    if not isinstance(listing, list):
        raise ValueError(f"manifest segments is not a list: {listing!r}")
    for row in listing:
        if (
            not isinstance(row, list)
            or len(row) != 2
            or not all(isinstance(x, str) for x in row)
        ):
            raise ValueError(f"malformed manifest segment row: {row!r}")
        if row[0] not in SEGMENT_KINDS:
            raise ValueError(f"unknown segment kind on the wire: {row[0]!r}")
    if not isinstance(inline, dict):
        raise ValueError(f"manifest inline is not a dict: {inline!r}")


def assemble_solve_header(
    listing, inline, pod_batch, pod_member,
    fetch: Callable[[str], Optional[bytes]],
) -> dict:
    """Rebuild the full solve header from a manifest. ``fetch`` is the
    SegmentStore lookup; any digest it cannot produce raises
    SegmentMissError with the complete missing set (ONE round trip
    repairs everything, not one per segment). Bucketed kinds re-sort into
    the encoders' canonical orders, so the assembled header is
    value-identical to the full-wire one."""
    from karpenter_core_tpu_torch.solver import codec

    check_manifest_parts(listing, inline)
    missing: List[str] = []
    groups: Dict[str, List] = {}
    for kind, dg in listing:
        data = fetch(dg)
        if data is None:
            missing.append(dg)
            continue
        try:
            groups.setdefault(kind, []).append(json.loads(data.decode()))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"malformed segment {dg[:12]}: {e}") from e
    if missing:
        raise SegmentMissError(sorted(set(missing)))

    for kind in (KIND_NODEPOOLS, KIND_CATALOG, KIND_DSPODS):
        if len(groups.get(kind, [])) != 1:
            raise ValueError(
                f"manifest needs exactly one {kind} segment, got"
                f" {len(groups.get(kind, []))}"
            )
    catalog = groups[KIND_CATALOG][0]
    if not isinstance(catalog, dict) or not {
        "it_table", "it_pools"
    } <= set(catalog):
        raise ValueError(f"malformed catalog segment: {type(catalog)}")
    nodes = [nd for bucket in groups.get(KIND_NODES, []) for nd in bucket]
    nodes.sort(key=lambda d: d.get("name") or "")

    topology = None
    if inline.get("has_topology"):
        if len(groups.get(KIND_TOPO_DOMAINS, [])) != 1:
            raise ValueError("manifest topology lost its domains segment")
        tpods = [
            t for bucket in groups.get(KIND_TOPO_PODS, []) for t in bucket
        ]
        tpods.sort(key=_topo_sort_key)
        topology = {
            "domains": groups[KIND_TOPO_DOMAINS][0],
            "existing_pods": tpods,
            "excluded": inline.get("topo_excluded") or [],
        }

    batches = groups.get(KIND_PODS, [])
    if len(pod_batch) != len(pod_member):
        raise ValueError("pod layout arrays disagree on length")
    pods = []
    for b, m in zip(pod_batch, pod_member):
        b, m = int(b), int(m)
        if not (0 <= b < len(batches)) or not (0 <= m < len(batches[b])):
            raise ValueError(f"pod layout entry ({b},{m}) out of range")
        pods.append(batches[b][m])

    header = {
        "version": codec.SOLVE_WIRE_VERSION,
        "nodepools": groups[KIND_NODEPOOLS][0],
        "it_table": catalog["it_table"],
        "it_pools": catalog["it_pools"],
        "existing_nodes": nodes,
        "daemonset_pods": groups[KIND_DSPODS][0],
        "pods": pods,
        "topology": topology,
        "max_slots": inline.get("max_slots"),
        "unavailable_offerings": inline.get("unavailable_offerings"),
        "tenant": inline.get("tenant", "default"),
        "solver_mode": inline.get("solver_mode", ""),
    }
    # prior-solve reference (incsolve, ISSUE 16): pod-half inline —
    # deliberately OUTSIDE fingerprint_of_parts' probe, so a request
    # naming its predecessor fingerprints identically to one that
    # doesn't (it must, or the reference could never name a hit). Key
    # omitted when empty, mirroring _encode_solve_header — assembly must
    # stay byte-exact against the full wire either way.
    if inline.get("prev_fingerprint"):
        header["prev_fingerprint"] = inline["prev_fingerprint"]
    return header


class SegmentStore:
    """TTL'd + LRU-bounded content-addressed byte store (daemon side).

    Bounded in entries AND bytes like the scheduler cache — segment
    bodies arrive from N tenants' snapshots, so an unbounded store is an
    OOM with extra steps. The TTL is idle-based and refreshed on every
    reference (``get``), so the working set of an active fleet never
    expires mid-conversation while a tenant that left takes its snapshot
    bytes with it one TTL later. Content addressing is verified at the
    upload site (codec checks sha256(body) == claimed digest), so a
    mismatched upload can never poison another tenant's manifest.

    All shared state is mutated under ``self._lock`` (the ``_locked``
    helper discipline graftlint GL302/GL303 checks). Purely in-memory:
    no disk or journal I/O, so the GL304 grant-region audit over the
    solver tree holds by construction — store puts/gets run in the
    request's pre-grant host phase anyway."""

    def __init__(
        self,
        max_bytes: int = DEFAULT_STORE_BYTES,
        max_entries: int = DEFAULT_STORE_ENTRIES,
        ttl: float = DEFAULT_STORE_TTL,
        time_fn=time.monotonic,
    ):
        if max_entries <= 0:
            raise ValueError(
                f"max_entries must be positive, got {max_entries}"
            )
        if ttl <= 0:
            raise ValueError(f"ttl must be positive, got {ttl}")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self.ttl = ttl
        self.time_fn = time_fn
        self._lock = threading.RLock()
        # digest -> [data, expires_at]; OrderedDict tail = most recent
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._bytes = 0
        self.evictions: Dict[str, int] = {}

    def get(self, digest: str) -> Optional[bytes]:
        with self._lock:
            ent = self._entries.get(digest)
            if ent is None:
                return None
            now = self.time_fn()
            if now >= ent[1]:
                self._drop_locked(digest, "ttl")
                self._export_locked()
                return None
            ent[1] = now + self.ttl  # idle TTL: references keep it warm
            self._entries.move_to_end(digest)
            return ent[0]

    def put(self, digest: str, data: bytes) -> None:
        with self._lock:
            now = self.time_fn()
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[digest] = [data, now + self.ttl]
            self._bytes += len(data)
            self._sweep_expired_locked(now)
            while len(self._entries) > self.max_entries:
                self._evict_lru_locked("entries")
            # strict byte bound, scheduler-cache policy: even one
            # oversized snapshot may not pin more than the budget (the
            # solve still serves — the segment just re-uploads next time)
            while self._bytes > self.max_bytes and self._entries:
                self._evict_lru_locked("bytes")
            self._export_locked()

    def _sweep_expired_locked(self, now: float) -> None:
        with self._lock:
            for dg in [
                dg for dg, ent in self._entries.items() if now >= ent[1]
            ]:
                self._drop_locked(dg, "ttl")

    def _evict_lru_locked(self, reason: str) -> None:
        with self._lock:
            dg = next(iter(self._entries))
            self._drop_locked(dg, reason)

    def _drop_locked(self, digest: str, reason: str) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            data, _exp = self._entries.pop(digest)
            self._bytes -= len(data)
            self.evictions[reason] = self.evictions.get(reason, 0) + 1
        m.SOLVERD_SEGSTORE_EVICTIONS.inc({"reason": reason})

    def _export_locked(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            m.SOLVERD_SEGSTORE_ENTRIES.set(float(len(self._entries)))
            m.SOLVERD_SEGSTORE_BYTES.set(float(self._bytes))

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "evictions": dict(self.evictions),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, digest: str) -> bool:
        with self._lock:
            ent = self._entries.get(digest)
            return ent is not None and self.time_fn() < ent[1]

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes


class SentCache:
    """Client-side ledger of segments a sidecar INSTANCE has confirmed.

    Keyed per sidecar identity: every solverd boot mints an instance id
    (rode back on the ``X-Solverd-Instance`` response header and on miss
    answers), and ``rebind`` to a NEW id drops the whole sent-set — a
    respawned member starts cold, and the next manifest's optimistic
    elision is repaired by exactly one typed-miss re-upload. Bounded in
    digests (LRU) so a long-lived operator cannot leak one entry per
    historical segment forever."""

    def __init__(self, max_digests: int = DEFAULT_SENT_DIGESTS):
        if max_digests <= 0:
            raise ValueError(
                f"max_digests must be positive, got {max_digests}"
            )
        self.max_digests = max_digests
        self._lock = threading.RLock()
        self._instance: str = ""
        self._known: "OrderedDict[str, None]" = OrderedDict()
        # the last listing this instance resolved (digest + rows): the
        # base the next manifest ships row EDITS against
        self._base_digest: str = ""
        self._base_rows: List[List[str]] = []

    def instance(self) -> str:
        with self._lock:
            return self._instance

    def rebind(self, instance: str) -> bool:
        """Point the ledger at a sidecar instance; a CHANGED id clears it
        (the old process's store died with it). Returns True on a clear."""
        with self._lock:
            if instance == self._instance:
                return False
            self._instance = instance
            self._known.clear()
            self._base_digest = ""
            self._base_rows = []
            return True

    def base(self):
        """(listing digest, rows) of the last confirmed listing, or None
        before any solve / after a rebind."""
        with self._lock:
            if not self._base_digest:
                return None
            return self._base_digest, self._base_rows

    def set_base(self, digest: str, rows) -> None:
        with self._lock:
            self._base_digest = digest
            self._base_rows = [list(r) for r in rows]

    def drop_base(self) -> None:
        """The far side reported the base listing missing: stop naming it
        (the next manifest ships its full listing)."""
        with self._lock:
            self._base_digest = ""
            self._base_rows = []

    def known(self, digest: str) -> bool:
        with self._lock:
            return digest in self._known

    def mark(self, digests) -> None:
        with self._lock:
            for dg in digests:
                self._known[dg] = None
                self._known.move_to_end(dg)
            while len(self._known) > self.max_digests:
                self._known.popitem(last=False)

    def forget(self, digests) -> None:
        """Drop specific digests (a miss answer proved the far side lost
        them — e.g. TTL/LRU eviction on a live instance)."""
        with self._lock:
            for dg in digests:
                self._known.pop(dg, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._known)
