"""The FFD class scan through the hand-written CUDA kernel.

Replaces both routes of ``karpenter_core_tpu/ops/pallas_ffd.py``'s
``_fused_step`` (the ``pl.pallas_call`` at :135): the solo route
(``_pallas_ffd_solve_impl``, ``pallas_ffd_solve[_donated]``) and the
batched one (``_pallas_ffd_solve_batched_impl``,
``pallas_ffd_solve_batched[_donated]``). The kernel is
``csrc/ffd_step.cu``; its specification and oracle is the plain
``ops/ffd.ffd_step``. The source note there says what bounds a scan on the
card (latency: J x 4 grid barriers, the serial cross-slot decisions and
the per-slot chains of loads; the ~11 MB slot state of the 50k-pod problem
stays in L2) and how the design answers it (one persistent cooperative
launch per scan, a kept per-hostname-group flag instead of a rescan of the
counts, water-fill searches with one block barrier per four rounds).

Build: ``nvcc`` compiles the source into a shared library with a C
interface at first use, into ``karpenter_core_tpu_torch/build/`` (listed
in ``.gitignore``), keyed by a hash of the source and flags; ``ctypes``
loads it. Nothing is built or imported at module import.

``cuda_ffd_solve`` (one problem) and ``cuda_ffd_solve_batched`` (B stacked
problems) take the plain version for tensors on the CPU, launch the
kernel for tensors on a CUDA device, and raise for anything else; on the
card they never run the plain version. A solo scan is the batched kernel
at B = 1. The C entry ``ffd_scan`` launches the kernel (``KERNELS``) once
for the whole scan, all B problems and all J class steps, and the wrapper
adds one to ``counter.launches`` after the entry reports success.
``counter.rows`` counts the problem rows the launched scans served (B per
scan, pad rows included), which tells one batched scan from B solo ones;
``counter.blocks`` is the grid of the last launch.

A step axis with a ``topo_rank`` plane (rack-aware gangs) hands the plane
to the kernel, whose existing-slot first-fit is then level-grouped; with
none the pointer is null and the classic prefix runs. The gang-atomic
solve's scans (``ops/gangsched.py``) run through the kernel in
``cuda_gang_solve`` and ``cuda_gang_solve_sharded``: one launch when
every gang commits, a second from the same init state when one rolls
back (one host read of the failure check decides). The sharded one is a
batched dispatch's route: the stacked problems split over the shards of
a device mesh (one shard on one device), every shard's first launch
before the first host read.

The kernel reads the requirement plane bit-packed (``pack_values``: [...,
V/8] bytes, bit v % 8 of byte v / 8 the value v, as
``numpy.packbits(..., bitorder="little")``). The solo, batched and gang
routes keep the port's layout, bool ``SlotState.valmask`` [.., N, K, V]:
their wrapper packs the plane (and the templates' ``tmpl_mask``) before the
launch and unpacks the final plane into the caller's tensor after it. A
state whose plane is packed already (``pack_state``) is launched as it is
and stays packed. The consolidation sweep has its own entry,
``cuda_ffd_solve_prefixes``: its stack's state is packed
(``models/consolidation._prefix_scan`` packs the prepared state once, then
copies it) and its final plane stays packed, since the sweep never reads
it (``unpack_state`` gives the port's layout back); its launches are also
counted in ``counter.prefix_launches``. The class steps and the statics of
a batched scan may be one row expanded over the problem axis (stride 0, as
the sweep's are): the kernel then reads that one copy for every problem.
The slot state must be a real contiguous stack, since the kernel writes
it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from karpenter_core_tpu_torch.ops import ffd as ffd_ops
from karpenter_core_tpu_torch.ops import gangsched
from karpenter_core_tpu_torch.ops.ffd import (
    LEVEL_ITERS,
    ClassStep,
    FFDStatics,
    SlotState,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ffd_step.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# Z and CT (zone and capacity-type vocab widths) ride 64-bit masks
_MAX_ZONE_CT = 64
# dynamic shared memory a block can have on Hopper
_SMEM_MAX = 227 * 1024


# the scan's one kernel (csrc/ffd_step.cu), launched by the C entry ffd_scan
KERNELS = ("k_ffd_scan",)


class LaunchCounter:
    """Launches of the scan kernel on the card, those of them made through
    the sweep's entry (``cuda_ffd_solve_prefixes``), the problem rows the
    launched scans served, and the grid (blocks) of the last launch; plain
    integers."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = dict.fromkeys(KERNELS, 0)
        self.prefix_launches = 0
        self.rows = 0
        self.blocks = 0

    def total(self) -> int:
        return sum(self.launches.values())


counter = LaunchCounter()

_POINTERS = (
    # slot state
    "valmask", "defines", "complement", "negative", "gt", "lt", "itmask",
    "requests", "capacity", "kind", "tmpl", "podcount", "next_free",
    "overflow", "hcount", "zcount", "carry",
    # class steps
    "c_mask", "c_defines", "c_concrete", "c_negative", "c_gt", "c_lt",
    "c_count", "c_requests", "c_class_it", "c_tmpl_ok", "c_exist_taint_ok",
    "c_new_template", "c_kstar", "c_smask", "c_h_sel", "c_h_owner",
    "c_z_sel", "c_z_owner", "c_sub_value", "c_sub_first", "c_sub_last",
    "c_wf_group", "c_wf_key", "c_zone_rest", "c_topo_rank",
    # statics
    "it_alloc", "off_avail", "zone_key", "ct_key", "t_mask", "t_defines",
    "t_complement", "t_negative", "t_gt", "t_lt", "t_it", "t_overhead",
    "well_known", "h_type", "h_skew", "h_possel0", "z_type", "z_skew",
    "z_key", "z_mindom", "z_domains", "z_rank",
    # outputs
    "takes", "unplaced",
    # scratch
    "sc", "eff", "hboot", "k_fresh", "off_fresh", "k_eff", "feas", "take",
    "hflag", "wf", "offm", "req_alt", "kv", "fc", "open", "stamps",
)
_DIMS = ("N", "K", "V", "T", "R", "S", "Z", "CT", "Gh", "Gz", "level_iters",
         "B", "J", "step_stride", "static_stride", "pad_")
_SC_COUNT = 7  # csrc/ffd_step.cu SC_COUNT_
_STAMPS = 5  # csrc/ffd_step.cu STAMPS: step start, then each stage's end


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _POINTERS] + [
        (name, ctypes.c_int32) for name in _DIMS
    ]


_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA FFD kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libffd_step_{digest}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.ffd_args_size.argtypes = []
        lib.ffd_args_size.restype = ctypes.c_int
        lib.ffd_scan_smem.argtypes = [ctypes.c_int] * 4
        lib.ffd_scan_smem.restype = ctypes.c_int
        lib.ffd_scan.argtypes = [
            ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ffd_scan.restype = ctypes.c_int
        lib.ffd_error_string.argtypes = [ctypes.c_int]
        lib.ffd_error_string.restype = ctypes.c_char_p
        if lib.ffd_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError(
                f"FfdArgs layout mismatch: C {lib.ffd_args_size()} bytes,"
                f" Python {ctypes.sizeof(_Args)}"
            )
        _lib = lib
        return lib


def pack_values(mask: torch.Tensor) -> torch.Tensor:
    """A bool [..., V] value plane as the kernel reads it: uint8 [...,
    V/8], bit v % 8 of byte v / 8 the value v (``numpy.packbits(mask, -1,
    bitorder="little")``). A leading axis of stride 0 (one row shared over
    the problem axis) stays one packed row, expanded."""
    if mask.dim() > 1 and mask.shape[0] > 1 and mask.stride(0) == 0:
        row = pack_values(mask[0])
        return row.unsqueeze(0).expand(mask.shape[0], *row.shape)
    *lead, V = mask.shape
    if V % 8:
        raise ValueError(f"value width {V} is not a multiple of 8")
    bits = mask.view(torch.uint8).reshape(*lead, V // 8, 8)
    return (bits << _shifts(mask.device)).sum(-1, dtype=torch.uint8)


def unpack_values(packed: torch.Tensor, out: torch.Tensor | None = None):
    """``pack_values`` undone: uint8 [..., V/8] -> bool [..., V], into
    ``out`` (a contiguous bool tensor of that shape) when given."""
    *lead, VB = packed.shape
    if out is None:
        out = torch.empty((*lead, VB * 8), dtype=torch.bool,
                          device=packed.device)
    bits = packed.unsqueeze(-1) >> _shifts(packed.device)
    torch.bitwise_and(bits, 1, out=out.view(torch.uint8).view(*lead, VB, 8))
    return out


def pack_state(state: SlotState) -> SlotState:
    """``state`` with its requirement plane packed (``pack_values``), as
    the sweep's stack is built for ``cuda_ffd_solve_prefixes``."""
    return state._replace(valmask=pack_values(state.valmask))


def unpack_state(state: SlotState) -> SlotState:
    """``state`` in the port's layout, bool ``valmask`` [.., N, K, V]: its
    plane unpacked when it is packed (``pack_state``), else ``state``."""
    if state.valmask.dtype == torch.bool:
        return state
    return state._replace(valmask=unpack_values(state.valmask))


def _shifts(device):
    return torch.arange(8, dtype=torch.uint8, device=device)


def _eff_bytes(K, V):
    """csrc/ffd_step.cu eff_bytes: a problem's eff scratch (the packed
    effective class mask and three [K] rows, 16-byte aligned)."""
    return (K * (V // 8) + 3 * K + 15) // 16 * 16


def _check(name, x, dtype, shape, device, shared=False):
    """``x``'s address after checking its type, shape, device and layout:
    contiguous, or with ``shared`` one row expanded over the leading
    problem axis (stride 0) that every problem reads. An empty plane is
    never read, so any layout will do."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.numel() == 0:
        return x.data_ptr()
    if shared:
        if x.stride(0) != 0 or not x[0].is_contiguous():
            raise ValueError(f"{name}: not one contiguous row shared over"
                             " the problem axis (stride 0)")
    elif not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous (only class steps and"
                         " statics may be a stride-0 expand; the kernel"
                         " writes the slot state, a real row a problem)")
    return x.data_ptr()


def _problem_stride(name, tree, skip=()):
    """The problem stride of a read-only tree: 1 when its leaves are
    contiguous stacks, 0 when each is one row expanded over the problem
    axis (stride 0); ``skip`` names leaves left out of the test."""
    leaves = [x for f, x in zip(tree._fields, tree)
              if x is not None and f not in skip and x.numel()]
    if all(x.is_contiguous() for x in leaves):
        return 1
    if all(x.stride(0) == 0 and x[0].is_contiguous() for x in leaves):
        return 0
    raise ValueError(f"{name}: leaves neither all contiguous stacks nor all"
                     " one row shared over the problem axis (stride 0)")


def cuda_ffd_solve(state: SlotState, steps: ClassStep, statics: FFDStatics,
                   level_iters: int = LEVEL_ITERS, *, _max_blocks: int = 0,
                   _stamps: torch.Tensor | None = None):
    """Scan all stacked class steps; returns (final state, takes [J, N]
    int32, unplaced [J] int32) exactly as ``ops/ffd.ffd_solve``. The input
    state is not modified (the kernel updates a copy in place).

    On the card only: ``_max_blocks`` > 0 caps the grid (a check that the
    kernel's loops are right when the items far exceed it), and
    ``_stamps``, a [J, 5] int64 tensor on the device, receives the device
    clock in ns at the start of each step and after each of its four
    stages."""
    dev = state.kind.device
    if dev.type == "cpu":
        return ffd_ops.ffd_solve(state, steps, statics, level_iters)
    if dev.type != "cuda":
        raise ValueError(f"cuda_ffd_solve: unsupported device {dev}")
    return _launch(state, steps, statics, level_iters, _max_blocks, _stamps)


def cuda_ffd_solve_batched(state: SlotState, steps: ClassStep,
                           statics: FFDStatics,
                           level_iters: int = LEVEL_ITERS, *,
                           _max_blocks: int = 0,
                           _stamps: torch.Tensor | None = None):
    """Scan B stacked problems (every leaf with a leading [B] axis);
    returns (final states [B, ...], takes [B, J, N] int32, unplaced [B, J]
    int32) exactly as ``ops/ffd.ffd_solve_batched``. On the card the
    kernel writes the final states into ``state``'s own tensors, which are
    returned: the caller hands a fresh stack (``_run_kernel_batched`` does)
    and keeps no other use of it. ``_max_blocks`` and ``_stamps`` as in
    ``cuda_ffd_solve``."""
    dev = state.kind.device
    if dev.type == "cpu":
        return ffd_ops.ffd_solve_batched(state, steps, statics, level_iters)
    if dev.type != "cuda":
        raise ValueError(f"cuda_ffd_solve_batched: unsupported device {dev}")
    return _launch_batched(state, steps, statics, level_iters, _max_blocks,
                           _stamps)


def cuda_ffd_solve_prefixes(state: SlotState, steps: ClassStep,
                            statics: FFDStatics,
                            level_iters: int = LEVEL_ITERS, *,
                            _max_blocks: int = 0,
                            _stamps: torch.Tensor | None = None):
    """The consolidation sweep's batched scan (``models/consolidation``
    ``_prefix_scan``): ``cuda_ffd_solve_batched`` over B prefix rows whose
    ``state.valmask`` is packed, uint8 [B, N, K, V/8] (``pack_state``),
    and whose class steps (less ``count``) and statics may be one row
    expanded over the prefix axis (stride 0). Returns (final states [B,
    ...] with the plane still packed, takes [B, J, N] int32, unplaced [B,
    J] int32). On the card the kernel writes the final states into
    ``state``'s own tensors, which are returned, and the launch is also
    counted in ``counter.prefix_launches``. For tensors on the CPU it
    unpacks the plane, takes the plain version through
    ``cuda_ffd_solve_batched`` and packs the final plane."""
    dev = state.kind.device
    if dev.type == "cpu":
        final, takes, unplaced = cuda_ffd_solve_batched(
            unpack_state(state), steps, statics, level_iters)
        return pack_state(final), takes, unplaced
    if dev.type != "cuda":
        raise ValueError(f"cuda_ffd_solve_prefixes: unsupported device {dev}")
    return _launch_prefixes(state, steps, statics, level_iters, _max_blocks,
                            _stamps)


def _launch_prefixes(state: SlotState, steps: ClassStep,
                     statics: FFDStatics, level_iters: int,
                     max_blocks: int = 0, stamps=None):
    """The sweep's launch on the card: the batched one over its packed
    stack, also counted in ``counter.prefix_launches``."""
    out = _launch_batched(state, steps, statics, level_iters, max_blocks,
                          stamps)
    counter.prefix_launches += 1
    return out


def cuda_gang_solve(state: SlotState, steps: ClassStep,
                    statics: FFDStatics, gang_of_step, gang_min,
                    level_iters: int = LEVEL_ITERS):
    """The gang-atomic solve (``ops/gangsched.gang_solve``) with both of its
    scans through ``cuda_ffd_solve``: one launch when every gang commits,
    two when one rolls back. The failure check and the cascade guard stay
    torch ops on the device; one host read decides the second scan. On CPU
    tensors it is the plain version."""
    dev = state.kind.device
    if dev.type == "cpu":
        return gangsched.gang_solve(state, steps, statics, gang_of_step,
                                    gang_min, level_iters)
    if dev.type != "cuda":
        raise ValueError(f"cuda_gang_solve: unsupported device {dev}")
    return gangsched.gang_solve_with(cuda_ffd_solve, state, steps, statics,
                                     gang_of_step, gang_min, level_iters)


def cuda_gang_solve_sharded(shards, level_iters: int = LEVEL_ITERS):
    """``cuda_gang_solve`` over stacked problems, split into the shards of
    a problem axis (each a (state, steps, statics, gang_of_step, gang_min)
    tuple on its own device of a mesh; one shard on one device), through
    ``cuda_ffd_solve_batched``: every shard's first launch goes out before
    the first host read, then a second launch over each shard whose rows'
    gangs failed (failed counts zeroed). The batched kernel writes its
    state in place, so each scan gets its own copy of the shard's state,
    and the shards' states are left as they were. On CPU tensors it is the
    plain version."""
    dev = shards[0][0].kind.device
    if dev.type == "cpu":
        return gangsched.gang_solve_sharded(shards, level_iters)
    if dev.type != "cuda":
        raise ValueError(f"cuda_gang_solve_sharded: unsupported device {dev}")
    return gangsched.gang_solve_sharded_with(_gang_scan, shards, level_iters)


def _gang_scan(state, steps, statics, level_iters):
    """A batched gang scan on the card, over its own copy of the state."""
    return _launch_batched(SlotState(*(x.clone() for x in state)), steps,
                           statics, level_iters)


def _launch(state: SlotState, steps: ClassStep, statics: FFDStatics,
            level_iters: int, max_blocks: int = 0, stamps=None):
    """The solo scan on the card: the batched kernel at B = 1, over a copy
    of the state."""
    st = SlotState(*(x.clone() for x in state))

    def one(tree):
        return type(tree)(*(None if x is None else x.unsqueeze(0)
                            for x in tree))

    _, takes, unplaced = _launch_batched(one(st), one(steps), one(statics),
                                         level_iters, max_blocks, stamps)
    return st, takes[0], unplaced[0]


@contextlib.contextmanager
def _device_stream(dev):
    """The current stream of ``dev`` as a handle for the C entry, with
    ``dev`` the current device meanwhile: the entry's ``cudaGetDevice``,
    occupancy query and ``cudaFuncSetAttribute`` then size the launch for
    that device. Each device has one current stream, so the shards of a
    virtual mesh over one card run one after another, never two
    cooperative grids on one card at once."""
    with torch.cuda.device(dev):
        yield ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _scratch(B, N, K, V, T, R, Gh, CT, dev):
    """The scan's per-problem scratch, as the kernel expects it at entry."""
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    return dict(
        sc=torch.empty((B, _SC_COUNT), dtype=i32, device=dev),
        eff=torch.empty((B, _eff_bytes(K, V)), dtype=u8, device=dev),
        hboot=torch.empty((B, Gh), dtype=u8, device=dev),
        k_fresh=torch.empty((B, T), dtype=f32, device=dev),
        off_fresh=torch.empty((B, T), dtype=u8, device=dev),
        k_eff=torch.empty((B, N), dtype=i32, device=dev),
        feas=torch.empty((B, N), dtype=u8, device=dev),
        take=torch.empty((B, N), dtype=i32, device=dev),
        hflag=torch.zeros((B, Gh), dtype=u8, device=dev),
        wf=torch.empty((B, 2 * N), dtype=i32, device=dev),
        offm=torch.empty((B, T * CT), dtype=torch.int64, device=dev),
        req_alt=torch.empty((B, N * R), dtype=f32, device=dev),
        kv=torch.full((B, N), -1, dtype=i32, device=dev),
        fc=torch.empty((B, N), dtype=i32, device=dev),
        open=torch.zeros((1,), dtype=i32, device=dev),
    )


def scratch_bytes(state: SlotState, statics: FFDStatics) -> int:
    """Bytes of the scratch a batched scan of these stacked problems
    allocates beside its inputs and outputs (its plane packed or not)."""
    B, N, K = state.valmask.shape[:3]
    V = state.zcount.shape[2]
    scratch = _scratch(B, N, K, V, state.itmask.shape[2],
                       state.requests.shape[2], state.hcount.shape[2],
                       statics.off_avail.shape[3], "meta")
    return sum(x.numel() * x.element_size() for x in scratch.values())


def _launch_batched(state: SlotState, steps: ClassStep, statics: FFDStatics,
                    level_iters: int, max_blocks: int = 0, stamps=None):
    """The scan on the card: one launch for all J class steps of all B
    problems; the state is updated in place. The kernel takes the plane
    packed: a packed plane (uint8, ``pack_state``) is launched as it is
    and stays so, a bool one is packed into a buffer before the launch and
    the final plane unpacked into ``state.valmask`` after it."""
    dev = state.kind.device
    packed = state.valmask.dtype == torch.uint8
    B, N, K = state.valmask.shape[:3]
    V = state.zcount.shape[2]
    T = state.itmask.shape[2]
    R = state.requests.shape[2]
    Gh = state.hcount.shape[2]
    Gz = state.zcount.shape[1]
    S = statics.tmpl_it.shape[1]
    _, _, Z, CT = statics.off_avail.shape
    J = steps.count.shape[1]
    if B <= 0:
        raise ValueError(f"cuda_ffd_solve_batched: {B} problem rows")
    if N <= 0:
        raise ValueError(f"cuda_ffd_solve: {N} slots")
    if J == 0:  # no class step: nothing to launch
        return (state,
                torch.empty((B, 0, N), dtype=torch.int32, device=dev),
                torch.empty((B, 0), dtype=torch.int32, device=dev))
    if Z > _MAX_ZONE_CT or CT > _MAX_ZONE_CT:
        raise ValueError(f"zone/capacity-type widths {Z}/{CT} exceed 64")
    # the kernel reads packed value rows in whole words of 1, 2, 4 or a
    # multiple of 8 bytes, and request rows as float4 (the prepare buckets
    # both widths to powers of two >= 8 and >= 4)
    if V < 8 or V & (V - 1) or R % 4:
        raise ValueError(f"value width {V} not a power of two >= 8, or"
                         f" resource width {R} not a multiple of 4")
    lib = build()
    if lib.ffd_scan_smem(N, K, V, Gz) > _SMEM_MAX:
        raise ValueError("the scan's shared memory exceeds 227 KB a block")
    # the read-only trees' problem strides: the class counts always have a
    # row a problem
    step_stride = _problem_stride("class steps", steps, skip=("count",))
    static_stride = _problem_stride("statics", statics)
    ss, ts = step_stride == 0, static_stride == 0

    b, i8, i32, f32 = torch.bool, torch.int8, torch.int32, torch.float32
    u8 = torch.uint8
    if packed:
        vm = state.valmask
    else:
        _check("valmask", state.valmask, b, (B, N, K, V), dev)
        vm = pack_values(state.valmask)
    t_mask = pack_values(statics.tmpl_mask)
    p = {}
    for name, x, dt, shape, shared in (
        ("valmask", vm, u8, (N, K, V // 8), False),
        ("defines", state.defines, b, (N, K), False),
        ("complement", state.complement, b, (N, K), False),
        ("negative", state.negative, b, (N, K), False),
        ("gt", state.gt, i32, (N, K), False),
        ("lt", state.lt, i32, (N, K), False),
        ("itmask", state.itmask, b, (N, T), False),
        ("requests", state.requests, f32, (N, R), False),
        ("capacity", state.capacity, f32, (N, R), False),
        ("kind", state.kind, i8, (N,), False),
        ("tmpl", state.template, i32, (N,), False),
        ("podcount", state.podcount, i32, (N,), False),
        ("next_free", state.next_free, i32, (), False),
        ("overflow", state.overflow, b, (), False),
        ("hcount", state.hcount, i32, (N, Gh), False),
        ("zcount", state.zcount, i32, (Gz, V), False),
        ("carry", state.carry, i32, (), False),
        ("c_mask", steps.mask, b, (J, K, V), ss),
        ("c_defines", steps.defines, b, (J, K), ss),
        ("c_concrete", steps.concrete, b, (J, K), ss),
        ("c_negative", steps.negative, b, (J, K), ss),
        ("c_gt", steps.gt, i32, (J, K), ss),
        ("c_lt", steps.lt, i32, (J, K), ss),
        ("c_count", steps.count, i32, (J,), False),
        ("c_requests", steps.requests, f32, (J, R), ss),
        ("c_class_it", steps.class_it, b, (J, T), ss),
        ("c_tmpl_ok", steps.tmpl_ok, b, (J, S), ss),
        ("c_exist_taint_ok", steps.exist_taint_ok, b, (J, N), ss),
        ("c_new_template", steps.new_template, i32, (J,), ss),
        ("c_kstar", steps.kstar, i32, (J,), ss),
        ("c_smask", steps.smask, b, (J, K, V), ss),
        ("c_h_sel", steps.h_sel, b, (J, Gh), ss),
        ("c_h_owner", steps.h_owner, b, (J, Gh), ss),
        ("c_z_sel", steps.z_sel, b, (J, Gz), ss),
        ("c_z_owner", steps.z_owner, b, (J, Gz), ss),
        ("c_sub_value", steps.sub_value, i32, (J,), ss),
        ("c_sub_first", steps.sub_first, b, (J,), ss),
        ("c_sub_last", steps.sub_last, b, (J,), ss),
        ("c_wf_group", steps.wf_group, i32, (J,), ss),
        ("c_wf_key", steps.wf_key, i32, (J,), ss),
        ("c_zone_rest", steps.zone_rest, b, (J, V), ss),
        ("it_alloc", statics.it_alloc, f32, (T, R), ts),
        ("off_avail", statics.off_avail, b, (T, Z, CT), ts),
        ("zone_key", statics.zone_key, i32, (), ts),
        ("ct_key", statics.ct_key, i32, (), ts),
        ("t_mask", t_mask, u8, (S, K, V // 8), ts),
        ("t_defines", statics.tmpl_defines, b, (S, K), ts),
        ("t_complement", statics.tmpl_complement, b, (S, K), ts),
        ("t_negative", statics.tmpl_negative, b, (S, K), ts),
        ("t_gt", statics.tmpl_gt, i32, (S, K), ts),
        ("t_lt", statics.tmpl_lt, i32, (S, K), ts),
        ("t_it", statics.tmpl_it, b, (S, T), ts),
        ("t_overhead", statics.tmpl_overhead, f32, (S, R), ts),
        ("well_known", statics.well_known, b, (K,), ts),
        ("h_type", statics.h_type, i32, (Gh,), ts),
        ("h_skew", statics.h_skew, i32, (Gh,), ts),
        ("h_possel0", statics.h_possel0, b, (Gh,), ts),
        ("z_type", statics.z_type, i32, (Gz,), ts),
        ("z_skew", statics.z_skew, i32, (Gz,), ts),
        ("z_key", statics.z_key, i32, (Gz,), ts),
        ("z_mindom", statics.z_mindom, i32, (Gz,), ts),
        ("z_domains", statics.z_domains, b, (Gz, V), ts),
        ("z_rank", statics.z_rank, i32, (Gz, V), ts),
    ):
        p[name] = _check(name, x, dt, (B, *shape), dev, shared)

    # the level plane of rack-aware gangs; null runs the classic first-fit
    p["c_topo_rank"] = (None if steps.topo_rank is None else
                        _check("c_topo_rank", steps.topo_rank, i32,
                               (B, J, N), dev, ss))

    # outputs and per-problem scratch (the kernel allocates nothing itself)
    takes = torch.empty((B, J, N), dtype=i32, device=dev)
    unplaced = torch.empty((B, J), dtype=i32, device=dev)
    scratch = _scratch(B, N, K, V, T, R, Gh, CT, dev)
    p["takes"] = takes.data_ptr()
    p["unplaced"] = unplaced.data_ptr()
    for name, x in scratch.items():
        p[name] = x.data_ptr()
    p["stamps"] = (None if stamps is None else
                   _check("stamps", stamps, torch.int64, (J, _STAMPS), dev))
    args = _Args(
        **p, N=N, K=K, V=V, T=T, R=R, S=S, Z=Z, CT=CT, Gh=Gh, Gz=Gz,
        level_iters=int(level_iters), B=B, J=J, step_stride=step_stride,
        static_stride=static_stride, pad_=0,
    )
    blocks = ctypes.c_int(0)
    with _device_stream(dev) as stream:
        rc = lib.ffd_scan(ctypes.byref(args), int(max_blocks), stream,
                          ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(
            f"ffd_scan launch failed: {lib.ffd_error_string(rc).decode()}")
    counter.launches[KERNELS[0]] += 1
    counter.rows += B
    counter.blocks = blocks.value
    if not packed:
        unpack_values(vm, out=state.valmask)
    return state, takes, unplaced
