"""JSON object codec for the API surface — the wire format of the HTTP
apiserver pair (kube/httpserver.py + kube/httpclient.py).

The reference's objects cross its process boundary as CRD JSON validated
by generated OpenAPI schemas (pkg/apis/crds/); here the API types are
Python dataclasses, so the codec is a tagged dataclass walker: every
dataclass value encodes as {"!t": <registered type name>, <field>: ...},
tuples/sets/frozensets get container tags (they matter — frozen dataclass
fields must stay hashable), and the two non-dataclass carriers
(ConditionSet, the dict-subclass Limits) get explicit handlers. No
pickling anywhere — the registry below is the closed world of decodable
types, so a malicious peer cannot instantiate arbitrary classes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from karpenter_core_tpu_torch.api import nodeclaim as _nodeclaim
from karpenter_core_tpu_torch.api import nodepool as _nodepool
from karpenter_core_tpu_torch.api import objects as _objects
from karpenter_core_tpu_torch.api.duration import NillableDuration
from karpenter_core_tpu_torch.api.status import Condition, ConditionSet

_TYPE_KEY = "!t"


def _registry() -> Dict[str, type]:
    reg: Dict[str, type] = {}
    for mod in (_objects, _nodepool, _nodeclaim):
        for name in dir(mod):
            cls = getattr(mod, name)
            if isinstance(cls, type) and dataclasses.is_dataclass(cls):
                reg[cls.__name__] = cls
    reg["NillableDuration"] = NillableDuration
    reg["Condition"] = Condition
    return reg


REGISTRY = _registry()
_NAMES = {cls: name for name, cls in REGISTRY.items()}


def encode(value: Any) -> Any:
    """Python object -> JSON-compatible structure."""
    if isinstance(value, ConditionSet):
        return {
            _TYPE_KEY: "ConditionSet",
            "types": list(value._types),
            "conditions": [encode(c) for c in value.all()],
        }
    if isinstance(value, _nodepool.Limits):
        return {_TYPE_KEY: "Limits", "items": dict(value)}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        name = _NAMES.get(type(value))
        if name is None:
            raise TypeError(f"unregistered type {type(value).__name__}")
        out = {_TYPE_KEY: name}
        for f in dataclasses.fields(value):
            out[f.name] = encode(getattr(value, f.name))
        return out
    if isinstance(value, dict):
        return {k: encode(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return {_TYPE_KEY: "!tuple", "items": [encode(v) for v in value]}
    if isinstance(value, frozenset):
        # tagged separately from set: frozen dataclass fields must decode
        # back hashable (a plain set would TypeError on first hash)
        return {
            _TYPE_KEY: "!frozenset",
            "items": sorted(encode(v) for v in value),
        }
    if isinstance(value, set):
        return {_TYPE_KEY: "!set", "items": sorted(encode(v) for v in value)}
    if isinstance(value, list):
        return [encode(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(f"cannot encode {type(value).__name__}")


def decode(value: Any) -> Any:
    """JSON structure -> Python object (closed-world types only)."""
    if isinstance(value, list):
        return [decode(v) for v in value]
    if not isinstance(value, dict):
        return value
    tag = value.get(_TYPE_KEY)
    if tag is None:
        return {k: decode(v) for k, v in value.items()}
    if tag == "!tuple":
        return tuple(decode(v) for v in value["items"])
    if tag == "!set":
        return set(decode(v) for v in value["items"])
    if tag == "!frozenset":
        return frozenset(decode(v) for v in value["items"])
    if tag == "ConditionSet":
        cs = ConditionSet(*value.get("types", []))
        for c in decode(value.get("conditions", [])):
            cs._conditions[c.type] = c
        return cs
    if tag == "Limits":
        lim = _nodepool.Limits()
        lim.update(value.get("items", {}))
        return lim
    cls = REGISTRY.get(tag)
    if cls is None:
        raise TypeError(f"unknown wire type {tag!r}")
    # construct WITHOUT __init__/__post_init__: the wire already carries
    # the full derived state (e.g. Pod.resource_requests with overhead
    # folded in) — re-running derivation would re-apply overhead on every
    # round trip, inflating requests once per create/update/list hop
    obj = cls.__new__(cls)
    for f in dataclasses.fields(cls):
        if f.name in value:
            v = decode(value[f.name])
        elif f.default is not dataclasses.MISSING:
            v = f.default
        elif f.default_factory is not dataclasses.MISSING:
            v = f.default_factory()
        else:
            v = None
        object.__setattr__(obj, f.name, v)
    return obj


def sync_into(dest: Any, src: Any) -> None:
    """Copy src's dataclass fields into dest in place — how the client
    reflects server-assigned state (resourceVersion, timestamps, bind
    results) back into the caller's object, the way client-go decodes the
    response body into the passed object."""
    for f in dataclasses.fields(dest):
        setattr(dest, f.name, getattr(src, f.name))
