// The first-fit-decreasing class scan of the provisioning solve, for Hopper
// (sm_90a): all J class steps of B independent problems in one persistent
// cooperative launch.
//
// Replaces karpenter_core_tpu/ops/pallas_ffd.py::_fused_step (the
// pl.pallas_call at :135) on both of its routes: solo, and batched
// (batched=True, the vmap of ffd_step over a leading problem axis that
// _pallas_ffd_solve_batched_impl drives). Its body is ops/ffd.py::ffd_step;
// that function is this kernel's specification, and the port's plain
// version of it (karpenter_core_tpu_torch/ops/ffd.py) is its oracle: every
// output plane is bit-equal to it. A solo scan is B = 1. The arithmetic is
// integer-exact float32: every division is IEEE round-to-nearest
// (__fdiv_rn), every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the build also passes -fmad=false), the counts that JAX forms
// as float32 einsums are integer sums here, and int32 sums wrap as JAX's.
//
// What bounds it on this card: not bytes and not operations. A step touches
// the slot state once (the [N,T] itmask dominates, ~11 MB at N=4096,
// T=1024), which the 50 MB L2 holds, and its float work is a few MFLOP. A
// step is a chain of four dependent stages, each waiting on every slot or
// every problem before the next, and inside each a chain of dependent loads
// and reductions: so the scan is bound by latency, J x 4 grid barriers
// (~1.3 us each on the H100) plus the longest chain of each stage, above
// all the serial cross-slot decisions (an exclusive prefix, and the
// binary-search water-fill of level_iters rounds over the in-flight slots).
//
// What the design does about it:
//   * One launch per scan (ffd_scan): a persistent kernel, launched with
//     cudaLaunchCooperativeKernel on a grid sized from the occupancy
//     calculator so that every block is resident, walks all J steps and
//     separates the stages with grid barriers (cooperative_groups::
//     this_grid().sync(), which also orders memory between them). No host
//     call and no launch gap inside a scan.
//       1. prologue, problem b on block b mod gridDim.x: the class's
//          admissible-domain restriction (a warp per label group), the
//          fresh-slot caps and the sub-step water-fill quota (a warp each);
//       2. feasibility, (problem, slot, part) items, one warp each: part 0
//          decides requirements, taints, hostname caps and an existing
//          slot's capacity, every part the best count over its share of
//          the slot's instance types (atomicMax into kv); on the threads
//          the items leave free, the [T] rows k_fresh / off_fresh of the
//          template, which only the merge reads;
//       3. decisions, problem b on block b mod gridDim.x: k_eff from the
//          parts, first-fit over existing slots by an exclusive block scan
//          (level-grouped when the step carries a topo_rank row: the
//          rack-aware gangs' fill, ops/ffd.py ffd_step, where all capacity
//          at network level 0 fills before level 1; its four level sums
//          ride one more block scan, so a topo step costs one barrier
//          more and a classic step nothing),
//          the emptiest-first water-fill over in-flight slots, the
//          single-slot rule, the fresh range and the state scalars;
//       4. merge, (problem, slot, part) items of the slots that joined:
//          every part its types' itmask, part 0 the requirement planes,
//          requests, capacity, kind/template, podcount, hcount and the
//          zcount deltas (integer atomicAdd, order-free); the other slots
//          carry their requests over.
//   * Width where the chain is long: the slot stages walk only the slots
//     below an open bound (every slot with kind > 0; the decisions raise it
//     over each fresh range), cut each slot's types into as many parts as
//     the resident warps allow, and issue a lane's loads for TU types
//     before using any (offerings as per-type zone masks made at scan
//     start, allocatable and requests as float4, value rows as 8-byte
//     words). Warp ranks interleave the blocks, so the open slots spread
//     over all SMs. Requests are double-buffered across steps (reqs()), so
//     a slot's parts read its old requests while part 0 writes the new.
//   * No [N, Gh] rescan. The prologue needs, per hostname group, whether
//     any slot has a positive count (pos_any of ops/ffd.py::_host_caps).
//     Counts only grow inside a scan: the merge adds takes[j, n] >= 0 (the
//     reference's new_hcount = hcount + take_all * h_sel, ops/ffd.py, with
//     every take clamped at 0 from below and the class count a pod count),
//     so a positive count stays positive. hflag [Gh] per problem is set
//     once from the initial counts at scan start and then by the merge for
//     each selected group whose slot count becomes positive; the prologue
//     reads it instead of the plane.
//   * Water-fills with fewer barriers. The decisions stage each slot's
//     record and the in-flight slots' (podcount, cap) list in shared
//     memory, and run the reference's level_iters rounds of binary search
//     DEPTH = 4 at a time: warp w sums the fill at node w of the tree of
//     the next four rounds' midpoints, one block barrier publishes the 15
//     outcomes, and every thread walks the tree with them, so the level is
//     the reference's on every input. The sub-step water-fill over values
//     does the same on one warp, a lane a node, 5 rounds a vote.
//
// The consolidation sweep (models/consolidation.py _prefix_scan: B = 100
// prefixes of one prepared problem, N = 2560 slots of which 2000 are open
// existing nodes, K = 16 keys of V = 512 values) runs in another regime:
// there the bound is bytes. Every step's feasibility stage reads the
// requirement plane of every open slot of every row, ~1.6 GB a step at one
// byte a value, which no L2 holds, while the decisions and the merge touch
// a few slots. So the design for that route is about those bytes:
//   * The requirement plane is bit-packed: valmask is [N, K, V/8], bit
//     v % 8 of byte v / 8 the value v (V a power of two >= 8), and so are
//     the planes it is ANDed with, the templates' t_mask [S, K, V/8] (the
//     wrapper packs it) and the step's effective class mask in eff (the
//     prologue writes it packed): 1 KB a slot at config 4, not 8.
//   * The feasibility read is coalesced: a warp takes a slot's K x V/8
//     bytes in contiguous units of up to 32 bytes (two 16-byte loads),
//     neighbouring lanes on neighbouring units and every lane busy (config
//     4: the slot's 1 KB in one round), and ORs each key's overlap
//     across the lanes of its units with shuffles; a key's leading lane
//     then applies the compatibility rules. The merge's intersect-on-add,
//     the zone/capacity-type rows and the label-group counts (set bits
//     walked with __ffsll) read the same packed words.
//   * Read-only trees are shared across the problem axis: step_stride and
//     static_stride (0 or 1) scale problem b's offset into the class steps
//     and the statics, so the sweep hands one copy of each (a stride-0
//     expand) instead of B; only the slot state and the per-row class
//     counts have a row each.
// The wrapper (ops/cuda_ffd.py) packs and unpacks the plane around the
// solo, batched and gang scans, whose public layout stays bool [N, K, V];
// the sweep's entry (cuda_ffd_solve_prefixes) stacks packed state and never
// unpacks it.
//
// Slot state changes inside the launch, so it is never read through __ldg
// or a const __restrict__ pointer (ro() is for class steps and statics
// only); the grid barriers order it. Fresh slots never write past N: an
// overflowing step fills [next_free, N) and raises the overflow flag, and
// the host retries with more slots. An optional stamp buffer [J, 5] takes
// %globaltimer from one thread of block 0 at the start of each step and
// after each of its four barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int BIGI = 1 << 30;
constexpr int RANK_NONE = 1 << 30;
constexpr float BIGF = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
// a block: 128 registers a thread at most (one block an SM at full use)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// in-flight slots the decisions keep in shared memory (more go to wf)
constexpr int WF_SMEM = 8192;
// up to this many slots the decisions stage each slot's record in shared
// memory; above it they read the records in place
constexpr int STAGE_MAX = 8192;
// instance types a lane takes at once in the slot stages' type loops
constexpr int TU = 4;
// the merge tests a warp's items for a joined slot 32 at a time when each
// warp has more than this many (a slot that did not join is skipped)
constexpr int MERGE_BATCH = 8;
// binary-search rounds of the claims' water-fill per block barrier: warp w
// evaluates node w of the tree of the next rounds' midpoints
constexpr int DEPTH = 4;
static_assert(WARPS >= (1 << DEPTH) - 1, "a warp for every node");
// ... and of the sub-step water-fill per warp vote (lane l, node l)
constexpr int WF_DEPTH = 5;
// block-reduction partials: two buffers of four values per warp
constexpr int RED_BYTES = 2 * 4 * 32 * (int)sizeof(int);
constexpr int STAMPS = 5;
// network-distance levels of the level-grouped first-fit (ops/ffd.py
// TOPO_LEVELS): same rack, same superpod, same zone, farther or unknown
constexpr int TOPO_LEVELS = 4;

// scalar scratch slots written by the prologue / the decisions
enum {
  SC_M = 0,
  SC_CARRY0,
  SC_FRESH_CAP,
  SC_SINGLE,
  SC_S,
  SC_NF_OLD,
  SC_NNEW,
  SC_COUNT_,
};

}  // namespace

extern "C" {

// Field order is mirrored by ops/cuda_ffd.py::_Args (pointers, then ints);
// ffd_args_size() lets the wrapper check the two layouts agree. Every
// pointer but stamps is to problem 0 of B problems laid out one after
// another, each plane's per-problem size as the comments say; the class
// steps (c_count aside) and the statics advance by step_stride and
// static_stride problems a problem (0: one copy that every problem reads).
struct FfdArgs {
  // slot state, updated in place
  uint8_t* valmask;     // [N,K,V/8]: bit v % 8 of byte v / 8 is value v
  uint8_t* defines;     // [N,K]
  uint8_t* complement;  // [N,K]
  uint8_t* negative;    // [N,K]
  int32_t* gt;          // [N,K]
  int32_t* lt;          // [N,K]
  uint8_t* itmask;      // [N,T]
  float* requests;      // [N,R]
  float* capacity;      // [N,R]
  int8_t* kind;         // [N]
  int32_t* tmpl;        // [N]
  int32_t* podcount;    // [N]
  int32_t* next_free;   // []
  uint8_t* overflow;    // []
  int32_t* hcount;      // [N,Gh]
  int32_t* zcount;      // [Gz,V]
  int32_t* carry;       // []
  // stacked class steps, leading [J]
  const uint8_t* c_mask;        // [J,K,V]
  const uint8_t* c_defines;     // [J,K]
  const uint8_t* c_concrete;    // [J,K]
  const uint8_t* c_negative;    // [J,K]
  const int32_t* c_gt;          // [J,K]
  const int32_t* c_lt;          // [J,K]
  const int32_t* c_count;       // [J]
  const float* c_requests;      // [J,R]
  const uint8_t* c_class_it;    // [J,T]
  const uint8_t* c_tmpl_ok;     // [J,S]
  const uint8_t* c_exist_taint_ok;  // [J,N]
  const int32_t* c_new_template;    // [J]
  const int32_t* c_kstar;       // [J]
  const uint8_t* c_smask;       // [J,K,V]
  const uint8_t* c_h_sel;       // [J,Gh]
  const uint8_t* c_h_owner;     // [J,Gh]
  const uint8_t* c_z_sel;       // [J,Gz]
  const uint8_t* c_z_owner;     // [J,Gz]
  const int32_t* c_sub_value;   // [J]
  const uint8_t* c_sub_first;   // [J]
  const uint8_t* c_sub_last;    // [J]
  const int32_t* c_wf_group;    // [J]
  const int32_t* c_wf_key;      // [J]
  const uint8_t* c_zone_rest;   // [J,V]
  const int32_t* c_topo_rank;   // [J,N] network level of each slot, or null
  // solve statics
  const float* it_alloc;        // [T,R]
  const uint8_t* off_avail;     // [T,Z,CT]
  const int32_t* zone_key;      // []
  const int32_t* ct_key;        // []
  const uint8_t* t_mask;        // [S,K,V/8], packed as valmask
  const uint8_t* t_defines;     // [S,K]
  const uint8_t* t_complement;  // [S,K]
  const uint8_t* t_negative;    // [S,K]
  const int32_t* t_gt;          // [S,K]
  const int32_t* t_lt;          // [S,K]
  const uint8_t* t_it;          // [S,T]
  const float* t_overhead;      // [S,R]
  const uint8_t* well_known;    // [K]
  const int32_t* h_type;        // [Gh]
  const int32_t* h_skew;        // [Gh]
  const uint8_t* h_possel0;     // [Gh]
  const int32_t* z_type;        // [Gz]
  const int32_t* z_skew;        // [Gz]
  const int32_t* z_key;         // [Gz]
  const int32_t* z_mindom;      // [Gz]
  const uint8_t* z_domains;     // [Gz,V]
  const int32_t* z_rank;        // [Gz,V]
  // outputs
  int32_t* takes;               // [J,N]
  int32_t* unplaced;            // [J]
  // scratch
  int32_t* sc;                  // [SC_COUNT_]
  uint8_t* eff;                 // [eff_bytes]: mask [K,V/8] (packed),
                                // defines, concrete, negative [K] each
  uint8_t* hboot;               // [Gh]
  float* k_fresh;               // [T]
  uint8_t* off_fresh;           // [T]
  int32_t* k_eff;               // [N]
  uint8_t* feas;                // [N]
  int32_t* take;                // [N]
  uint8_t* hflag;               // [Gh], zero on entry: some slot count > 0
  int32_t* wf;                  // [2N]: the decisions' list past WF_SMEM
  uint64_t* offm;               // [T,CT]: zones with an available offering
  float* req_alt;               // [N,R]: requests of odd steps (see reqs())
  int32_t* kv;                  // [N]: best k over a slot's types, -1 none
  int32_t* fc;                  // [N]: slot cap if compatible, else -1
  int32_t* open;                // [1] for the whole launch: slots below
                                // it may be open (kind > 0), all problems
  int64_t* stamps;              // [J,STAMPS] for the whole launch, or null
  // dims; B problems of J class steps each; the problem strides of the
  // class steps and of the statics (1, or 0 when every problem shares one)
  int32_t N, K, V, T, R, S, Z, CT, Gh, Gz, level_iters, B, J;
  int32_t step_stride, static_stride, pad_;
};

}  // extern "C"

namespace {

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// bytes of a problem's eff scratch: the packed mask, then three [K] rows,
// rounded up so that every problem's mask starts 16-byte aligned
__host__ __device__ __forceinline__ int eff_bytes(int K, int V) {
  return align16(K * (V >> 3) + 3 * K);
}

// the arguments with every pointer moved to problem b's planes
__device__ __forceinline__ FfdArgs problem(const FfdArgs& a, int b) {
  FfdArgs p = a;
  const size_t ub = (size_t)b;
  // the class steps' and the statics' problem, 0 when they are shared
  const size_t sb = ub * (size_t)a.step_stride;
  const size_t tb = ub * (size_t)a.static_stride;
  const size_t N = a.N, K = a.K, V = a.V, T = a.T, R = a.R, S = a.S;
  const size_t Gh = a.Gh, Gz = a.Gz, J = a.J, VB = V / 8;
  // slot state
  p.valmask += ub * N * K * VB;
  p.defines += ub * N * K;
  p.complement += ub * N * K;
  p.negative += ub * N * K;
  p.gt += ub * N * K;
  p.lt += ub * N * K;
  p.itmask += ub * N * T;
  p.requests += ub * N * R;
  p.capacity += ub * N * R;
  p.kind += ub * N;
  p.tmpl += ub * N;
  p.podcount += ub * N;
  p.next_free += ub;
  p.overflow += ub;
  p.hcount += ub * N * Gh;
  p.zcount += ub * Gz * V;
  p.carry += ub;
  // class steps (the counts have a row a problem)
  p.c_mask += sb * J * K * V;
  p.c_defines += sb * J * K;
  p.c_concrete += sb * J * K;
  p.c_negative += sb * J * K;
  p.c_gt += sb * J * K;
  p.c_lt += sb * J * K;
  p.c_count += ub * J;
  p.c_requests += sb * J * R;
  p.c_class_it += sb * J * T;
  p.c_tmpl_ok += sb * J * S;
  p.c_exist_taint_ok += sb * J * N;
  p.c_new_template += sb * J;
  p.c_kstar += sb * J;
  p.c_smask += sb * J * K * V;
  p.c_h_sel += sb * J * Gh;
  p.c_h_owner += sb * J * Gh;
  p.c_z_sel += sb * J * Gz;
  p.c_z_owner += sb * J * Gz;
  p.c_sub_value += sb * J;
  p.c_sub_first += sb * J;
  p.c_sub_last += sb * J;
  p.c_wf_group += sb * J;
  p.c_wf_key += sb * J;
  p.c_zone_rest += sb * J * V;
  if (p.c_topo_rank != nullptr) p.c_topo_rank += sb * J * N;
  // statics
  p.it_alloc += tb * T * R;
  p.off_avail += tb * T * (size_t)a.Z * (size_t)a.CT;
  p.zone_key += tb;
  p.ct_key += tb;
  p.t_mask += tb * S * K * VB;
  p.t_defines += tb * S * K;
  p.t_complement += tb * S * K;
  p.t_negative += tb * S * K;
  p.t_gt += tb * S * K;
  p.t_lt += tb * S * K;
  p.t_it += tb * S * T;
  p.t_overhead += tb * S * R;
  p.well_known += tb * K;
  p.h_type += tb * Gh;
  p.h_skew += tb * Gh;
  p.h_possel0 += tb * Gh;
  p.z_type += tb * Gz;
  p.z_skew += tb * Gz;
  p.z_key += tb * Gz;
  p.z_mindom += tb * Gz;
  p.z_domains += tb * Gz * V;
  p.z_rank += tb * Gz * V;
  // outputs
  p.takes += ub * J * N;
  p.unplaced += ub * J;
  // scratch
  p.sc += ub * SC_COUNT_;
  p.eff += ub * (size_t)eff_bytes(a.K, a.V);
  p.hboot += ub * Gh;
  p.k_fresh += ub * T;
  p.off_fresh += ub * T;
  p.k_eff += ub * N;
  p.feas += ub * N;
  p.take += ub * N;
  p.hflag += ub * Gh;
  p.wf += ub * 2 * N;
  p.offm += ub * T * (size_t)a.CT;
  p.req_alt += ub * N * R;
  p.kv += ub * N;
  p.fc += ub * N;
  return p;
}

// Requests are double-buffered across steps: step j reads them from
// reqs(a, j) and its merge writes every slot's into reqs(a, j + 1), so the
// merge's type parts can still read a slot's old requests while its first
// part writes the new ones. After an odd number of steps the kernel copies
// the last buffer back into requests.
__device__ __forceinline__ float* reqs(const FfdArgs& a, int j) {
  return (j & 1) ? a.req_alt : a.requests;
}

// the device clock into stamps[j, k], from one thread of block 0
__device__ __forceinline__ void stamp(const FfdArgs& a, int j, int k) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[(size_t)j * STAMPS + k] = (int64_t)t;
  }
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// int32 arithmetic with JAX's wrap-around
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// read-only for the whole launch (class steps, statics): the read-only path
template <class T>
__device__ __forceinline__ T ro(const T* p) {
  return __ldg(p);
}

// Packed value rows: a row of V values is V/8 bytes (VB), bit v % 8 of
// byte v / 8 the value v; V is a power of two >= 8, so VB is 1, 2, 4 or a
// multiple of 8 and every row is VB-aligned.

// the 64 values from byte 0 of p (a row's first word; `bytes` < 8: the
// row's bytes, the values past them 0)
__device__ __forceinline__ unsigned long long word_at(const uint8_t* p,
                                                     int bytes) {
  if (bytes >= 8) return *(const unsigned long long*)p;
  unsigned long long x = 0ull;
  for (int i = 0; i < bytes; ++i) x |= (unsigned long long)p[i] << (8 * i);
  return x;
}

// values [0, count) of the packed row p, ANDed with the row mask if given
// (count <= 64)
__device__ __forceinline__ unsigned long long row_bits(const uint8_t* p,
                                                      const uint8_t* mask,
                                                      int count, int VB) {
  unsigned long long x = word_at(p, VB);
  if (mask != nullptr) x &= word_at(mask, VB);
  return count >= 64 ? x : x & ((1ull << count) - 1ull);
}

__device__ __forceinline__ unsigned and_any(uint4 p, uint4 q) {
  return (p.x & q.x) | (p.y & q.y) | (p.z & q.z) | (p.w & q.w);
}

// whether the `ub` bytes at x and at y (ub a power of two <= 32, both
// ub-aligned) share a set bit; all loads issued before any is used
__device__ __forceinline__ bool unit_overlap(const uint8_t* x,
                                             const uint8_t* y, int ub) {
  if (ub == 32) {
    const uint4 p0 = ((const uint4*)x)[0], p1 = ((const uint4*)x)[1];
    const uint4 q0 = ((const uint4*)y)[0], q1 = ((const uint4*)y)[1];
    return (and_any(p0, q0) | and_any(p1, q1)) != 0u;
  }
  if (ub == 16) return and_any(*(const uint4*)x, *(const uint4*)y) != 0u;
  if (ub == 8) {
    return (*(const unsigned long long*)x & *(const unsigned long long*)y) != 0ull;
  }
  if (ub == 4) return (*(const unsigned*)x & *(const unsigned*)y) != 0u;
  if (ub == 2) {
    return (*(const unsigned short*)x & *(const unsigned short*)y) != 0;
  }
  return (*x & *y) != 0;
}

// the class's joined zone / capacity-type rows of slot n as bitmasks
// (Z, CT <= 64, checked by the wrapper)
__device__ __forceinline__ void joined_zone_ct(const FfdArgs& a, int n,
                                               int zk, int ck,
                                               const uint8_t* effm,
                                               const uint8_t* effd,
                                               unsigned long long* zb,
                                               unsigned long long* cb) {
  const int K = a.K, VB = a.V >> 3;
  *zb = row_bits(a.valmask + ((size_t)n * K + zk) * VB,
                 effd[zk] ? effm + zk * VB : nullptr, a.Z, VB);
  *cb = row_bits(a.valmask + ((size_t)n * K + ck) * VB,
                 effd[ck] ? effm + ck * VB : nullptr, a.CT, VB);
}

// type t has an available offering in a zone of zb and a capacity type of
// cb: offm[t, c] holds the zones of capacity type c (set at scan start
// from off_avail [T,Z,CT]), so the Z x CT lattice is CT word tests; every
// load is unconditional, so a caller's unrolled loop keeps them in flight
__device__ __forceinline__ bool offering_ok(const FfdArgs& a, int t,
                                            unsigned long long zb,
                                            unsigned long long cb) {
  const uint64_t* o = a.offm + (size_t)t * a.CT;
  bool ok = false;
  for (int c = 0; c < a.CT; ++c) {
    ok = ok | ((((cb >> c) & 1ull) != 0) & ((o[c] & zb) != 0));
  }
  return ok;
}

// (alloc - req) / r where r > 0, else BIG
__device__ __forceinline__ float head(float al, float q, float rr) {
  return rr > 0.f ? __fdiv_rn(__fsub_rn(al, q), rr) : BIGF;
}

// TU types t0, t0 + 32, ... of one lane: ok[u] = type u is below hi, in
// the slot's itmask (itm), compatible with the class (cit) and has an
// offering; kr[u] = floor(min_r head). The loads of all TU types are issued
// before any is used; R is a multiple of 4, so requests and allocatable
// rows load as float4.
__device__ __forceinline__ void types_at(const FfdArgs& a, int t0, int hi,
                                         const uint8_t* itm,
                                         const uint8_t* cit,
                                         unsigned long long zb,
                                         unsigned long long cb,
                                         const float* req, const float* creq,
                                         bool* ok, float* kr) {
  const int T = a.T, R = a.R;
  int tt[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    tt[u] = imin(t0 + 32 * u, T - 1);
    ok[u] = (t0 + 32 * u < hi) & (itm[tt[u]] != 0) & (ro(cit + tt[u]) != 0) &
            offering_ok(a, tt[u], zb, cb);
    kr[u] = __int_as_float(0x7f800000);  // +inf
  }
  for (int r0 = 0; r0 < R; r0 += 4) {
    const float4 rr = ro((const float4*)(creq + r0));
    const float4 q = *(const float4*)(req + r0);
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const float4 al = ro((const float4*)(a.it_alloc + (size_t)tt[u] * R + r0));
      kr[u] = fminf(kr[u], head(al.x, q.x, rr.x));
      kr[u] = fminf(kr[u], head(al.y, q.y, rr.y));
      kr[u] = fminf(kr[u], head(al.z, q.z, rr.z));
      kr[u] = fminf(kr[u], head(al.w, q.w, rr.w));
    }
  }
#pragma unroll
  for (int u = 0; u < TU; ++u) kr[u] = floorf(kr[u]);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = imin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = imax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// inclusive prefix over the lanes (wrapping)
__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// Block reductions with one barrier each: every warp reduces its lanes with
// shuffles and leaves its partials in the buffer of this call, which
// alternates between two (Red::next), so the next call can write while a
// slow warp still reads this one; after the one barrier each warp reduces
// the partials itself. Every thread of the block must take part.
struct Red {
  int* buf;   // [2][4][32]
  int calls;  // identical in every thread of the block
  __device__ __forceinline__ int* next() {
    int* p = buf + (calls & 1) * 4 * 32;
    ++calls;
    return p;
  }
};

__device__ __forceinline__ int block_sum(int x, Red& red) {
  int* p = red.next();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned v = warp_sum((unsigned)x);
  if (lane == 0) p[w] = (int)v;
  __syncthreads();
  return (int)warp_sum(lane < WARPS ? (unsigned)p[lane] : 0u);
}

// exclusive prefixes of x0 and x1 over the threads in thread order
// (wrapping), their totals, and the block's max of mx and min of mn
struct Scan2 {
  int ex0, ex1, tot0, tot1, mx, mn;
};

__device__ __forceinline__ Scan2 block_scan2(int x0, int x1, int mx, int mn,
                                             Red& red) {
  int* p = red.next();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned i0 = warp_scan((unsigned)x0, lane);
  const unsigned i1 = warp_scan((unsigned)x1, lane);
  mx = warp_max(mx);
  mn = warp_min(mn);
  if (lane == 31) {
    p[w] = (int)i0;
    p[32 + w] = (int)i1;
    p[64 + w] = mx;
    p[96 + w] = mn;
  }
  __syncthreads();
  const bool in = lane < WARPS;
  const unsigned s0 = warp_scan(in ? (unsigned)p[lane] : 0u, lane);
  const unsigned s1 = warp_scan(in ? (unsigned)p[32 + lane] : 0u, lane);
  Scan2 out;
  out.mx = warp_max(in ? p[64 + lane] : INT_MIN);
  out.mn = warp_min(in ? p[96 + lane] : INT_MAX);
  // this warp's offset: the inclusive prefix of the warps before it
  const unsigned b0 = __shfl_sync(FULL, s0, imax(w - 1, 0));
  const unsigned b1 = __shfl_sync(FULL, s1, imax(w - 1, 0));
  out.ex0 = (int)((w > 0 ? b0 : 0u) + i0 - (unsigned)x0);
  out.ex1 = (int)((w > 0 ? b1 : 0u) + i1 - (unsigned)x1);
  out.tot0 = (int)__shfl_sync(FULL, s0, 31);
  out.tot1 = (int)__shfl_sync(FULL, s1, 31);
  return out;
}

// exclusive prefixes of the four level sums x[l] over the threads in
// thread order (wrapping) and their totals: the four running sums of the
// level-grouped first-fit, carried through one block scan (one barrier)
struct Scan4 {
  int ex[TOPO_LEVELS], tot[TOPO_LEVELS];
};

__device__ __forceinline__ Scan4 block_scan4(const int (&x)[TOPO_LEVELS],
                                             Red& red) {
  int* p = red.next();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned inc[TOPO_LEVELS];
#pragma unroll
  for (int l = 0; l < TOPO_LEVELS; ++l) {
    inc[l] = warp_scan((unsigned)x[l], lane);
    if (lane == 31) p[32 * l + w] = (int)inc[l];
  }
  __syncthreads();
  const bool in = lane < WARPS;
  Scan4 out;
#pragma unroll
  for (int l = 0; l < TOPO_LEVELS; ++l) {
    const unsigned s = warp_scan(in ? (unsigned)p[32 * l + lane] : 0u, lane);
    const unsigned b = __shfl_sync(FULL, s, imax(w - 1, 0));
    out.ex[l] = (int)((w > 0 ? b : 0u) + inc[l] - (unsigned)x[l]);
    out.tot[l] = (int)__shfl_sync(FULL, s, 31);
  }
  return out;
}

// a slot's level, clipped into [0, TOPO_LEVELS) as ops/ffd.py clips it
__device__ __forceinline__ int topo_level(const int32_t* topo, int n) {
  return imin(imax(topo[n], 0), TOPO_LEVELS - 1);
}
// v[l] += x and v[l], for a level l known only at run time, without
// indexing the register array dynamically
__device__ __forceinline__ void level_add(int (&v)[TOPO_LEVELS], int l,
                                          int x) {
#pragma unroll
  for (int i = 0; i < TOPO_LEVELS; ++i) v[i] = i == l ? wadd(v[i], x) : v[i];
}
__device__ __forceinline__ int level_get(const int (&v)[TOPO_LEVELS], int l) {
  int r = v[0];
#pragma unroll
  for (int i = 1; i < TOPO_LEVELS; ++i) r = i == l ? v[i] : r;
  return r;
}

// One round of the reference's binary search for the largest level whose
// fill fits: lo/hi move to the upper or lower half by the outcome ok.
__device__ __forceinline__ int mid_of(int lo, int hi) {
  return wadd(wadd(lo, hi), 1) >> 1;
}
__device__ __forceinline__ void search_step(int* lo, int* hi, bool ok) {
  const int mid = mid_of(*lo, *hi);
  *lo = ok ? mid : *lo;
  *hi = ok ? *hi : mid - 1;
}
// The midpoint that node `node` of the tree of the next rounds (heap order:
// node 0 the first round's, children 2i + 1 (not ok) and 2i + 2 (ok))
// would test, replaying the outcomes on its path from (lo, hi). Evaluating
// every node of d levels at once and then walking the tree with the actual
// outcomes is exactly d rounds of the search.
__device__ __forceinline__ int node_mid(int lo, int hi, int node) {
  const int i1 = node + 1;
  const int depth = 31 - __clz(i1);
  for (int pos = depth - 1; pos >= 0; --pos) search_step(&lo, &hi, (i1 >> pos) & 1);
  return mid_of(lo, hi);
}
__device__ __forceinline__ void walk(int* lo, int* hi, int d,
                                     unsigned okbits) {
  int i1 = 1;
  for (int k = 0; k < d; ++k) {
    const bool ok = (okbits >> (i1 - 1)) & 1u;
    search_step(lo, hi, ok);
    i1 = 2 * i1 + (ok ? 1 : 0);
  }
}

// ---------------------------------------------------------------------------
// shared memory of a block: the reduction partials, then one region that
// the prologue and the decisions use in turn (grid barriers between them)

__host__ __device__ __forceinline__ int prologue_bytes(int V, int Gz) {
  return (4 * V + Gz) * (int)sizeof(int) + Gz * V + Gz;
}

__host__ __device__ __forceinline__ int wf_smem_entries(int N) {
  return N < WF_SMEM ? N : WF_SMEM;
}

// the decisions' region: the in-flight list, then, when N <= STAGE_MAX,
// each slot's k_eff, podcount, take (int32) and kind, feasibility (bytes),
// thread-major: thread t's i-th slot at i * THREADS + t (no bank conflicts)
__host__ __device__ __forceinline__ int staged_slots(int N) {
  return (N + THREADS - 1) / THREADS * THREADS;
}
__host__ __device__ __forceinline__ int decide_bytes(int N) {
  const int wf = wf_smem_entries(N) * (int)sizeof(int2);
  const int P = staged_slots(N);
  return N <= STAGE_MAX ? wf + align16(3 * P * (int)sizeof(int) + 2 * P) : wf;
}

int scan_smem(const FfdArgs& a) {
  const int pro = align16(prologue_bytes(a.V, a.Gz));
  const int dec = decide_bytes(a.N);
  return RED_BYTES + (pro > dec ? pro : dec);
}

// ---------------------------------------------------------------------------
// 1. class prologue (one block per problem)

__device__ __forceinline__ void prologue(const FfdArgs& a, int j,
                                         unsigned char* region) {
  const int K = a.K, V = a.V, Gz = a.Gz, Gh = a.Gh;
  int* s_wcnt = (int*)region;         // [V]
  int* s_wcap = s_wcnt + V;           // [V]
  int* s_wrank = s_wcap + V;          // [V]
  int* s_wadm = s_wrank + V;          // [V]
  int* s_zkey = s_wadm + V;           // [Gz]
  uint8_t* s_adm = (uint8_t*)(s_zkey + Gz);  // [Gz*V]
  uint8_t* s_zown = s_adm + Gz * V;          // [Gz]: owned, not the pin's

  const uint8_t* cmask = a.c_mask + (size_t)j * K * V;
  const uint8_t* smask = a.c_smask + (size_t)j * K * V;
  const uint8_t* z_sel = a.c_z_sel + (size_t)j * Gz;
  const uint8_t* z_owner = a.c_z_owner + (size_t)j * Gz;
  const uint8_t* h_sel = a.c_h_sel + (size_t)j * Gh;
  const uint8_t* h_owner = a.c_h_owner + (size_t)j * Gh;
  const int wf_group = a.c_wf_group[j];
  const int wf_key = a.c_wf_key[j];
  const int sub_value = a.c_sub_value[j];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the region may still hold the last problem's rows

  // label-group admissible domains, one warp per group
  for (int g = warp; g < Gz; g += WARPS) {
    const int zk = a.z_key[g];
    const uint8_t* dom = a.z_domains + (size_t)g * V;
    const int* cnt = a.zcount + (size_t)g * V;
    const int* rk = a.z_rank + (size_t)g * V;
    int minc = INT_MAX, minrank = INT_MAX;
    unsigned supported = 0;
    bool any_pos = false;
    for (int v = lane; v < V; v += 32) {
      const bool padm = smask[zk * V + v] && dom[v];
      minc = imin(minc, padm ? cnt[v] : BIGI);
      supported += padm ? 1u : 0u;
      any_pos = any_pos || (padm && cnt[v] > 0);
      minrank = imin(minrank, padm ? rk[v] : RANK_NONE);
    }
    minc = warp_min(minc);
    minrank = warp_min(minrank);
    supported = warp_sum(supported);
    any_pos = __any_sync(FULL, any_pos);
    if (a.z_mindom[g] >= 0 && (int)supported < a.z_mindom[g]) minc = 0;
    if (lane == 0) {
      s_zkey[g] = zk;
      s_zown[g] = z_owner[g] && g != wf_group;
    }
    const int inc = z_sel[g] ? 1 : 0;
    const int type = a.z_type[g];
    for (int v = lane; v < V; v += 32) {
      const bool padm = smask[zk * V + v] && dom[v];
      const int c = cnt[v];
      bool adm;
      if (type == 0) {
        adm = padm && wsub(wadd(c, inc), minc) <= a.z_skew[g];
      } else if (type == 1) {
        adm = padm && c == 0;
      } else {
        const bool pos = padm && c > 0;
        const bool boot = padm && rk[v] == minrank;
        adm = any_pos ? pos : (z_sel[g] && boot);
      }
      s_adm[g * V + v] = adm;
    }
  }
  __syncthreads();

  // effective class requirements: restriction by owned groups + wf pin;
  // the mask packed, a thread a byte (values v0 .. v0 + 7 of key k), from
  // the last thread down (warps 0 and 1 go on to the step's quota)
  const bool has_wf = wf_group >= 0;
  const int VB = V >> 3;
  uint8_t* effd = a.eff + K * VB;
  for (int e = THREADS - 1 - tid; e < K * VB; e += THREADS) {
    const int k = e / VB, v0 = (e % VB) * 8;
    unsigned viol = 0u;  // bit i: value v0 + i outside an owned group's
    bool topo_def = false;
    for (int g = 0; g < Gz; ++g) {
      if (!(s_zown[g] && s_zkey[g] == k)) continue;
      topo_def = true;
      for (int i = 0; i < 8; ++i) viol |= s_adm[g * V + v0 + i] ? 0u : 1u << i;
    }
    const bool wf_oh = k == imax(wf_key, 0) && has_wf;
    topo_def = topo_def || wf_oh;
    unsigned bits = 0u;
    for (int i = 0; i < 8; ++i) {
      const int v = v0 + i;
      const bool pin_row = v == imax(sub_value, 0) && sub_value >= 0;
      const bool restr = !((viol >> i) & 1u) && (!wf_oh || pin_row);
      bits |= (cmask[k * V + v] && restr) ? 1u << i : 0u;
    }
    a.eff[e] = (uint8_t)bits;
    if (v0 == 0) {
      const size_t ck = (size_t)j * K + k;
      effd[k] = a.c_defines[ck] || topo_def;
      effd[K + k] = a.c_concrete[ck] || topo_def;
      effd[2 * K + k] = a.c_negative[ck] && !topo_def;
    }
  }
  // affinity groups that bootstrap: no positive count anywhere yet
  for (int g = tid; g < Gh; g += THREADS) {
    const bool pos_any = a.h_possel0[g] || a.hflag[g];
    a.hboot[g] = !pos_any && h_sel[g] && a.h_type[g] == 2;
  }
  __syncthreads();

  const int s = imax(a.c_new_template[j], 0);
  if (warp == 0) {
    // the step's pod quota: the class count, or the pinned sub-step
    // domain's share of the water-fill over values (one warp, lanes over V)
    const int count = a.c_count[j];
    const int carry0 = a.c_sub_first[j] ? count : *a.carry;
    int m = count;
    if (has_wf) {
      const int g = imax(wf_group, 0);
      const int zk = a.z_key[g];
      const uint8_t* rest = a.c_zone_rest + (size_t)j * V;
      unsigned supported = 0;
      for (int v = lane; v < V; v += 32) {
        supported += (smask[zk * V + v] && a.z_domains[(size_t)g * V + v]) ? 1u : 0u;
      }
      supported = warp_sum(supported);
      const int mindom = a.z_mindom[g];
      const bool unsat = mindom >= 0 && (int)supported < mindom;
      int hi = INT_MIN;
      for (int v = lane; v < V; v += 32) {
        const int c = a.zcount[(size_t)g * V + v];
        s_wcnt[v] = c;
        s_wcap[v] = imax(unsat ? imax(wsub(a.z_skew[g], c), 0) : BIGI, 0);
        s_wrank[v] = a.z_rank[(size_t)g * V + v];
        s_wadm[v] = rest[v];
        hi = imax(hi, rest[v] ? c : 0);
      }
      hi = warp_max(hi);
      __syncwarp();
      const int mq = carry0;
      hi = wadd(hi, mq);
      int lo = 0;
      // level_iters rounds of the binary search, WF_DEPTH a vote: lane l
      // sums the fill over all values at node l's midpoint
      for (int left = a.level_iters; left > 0; left -= WF_DEPTH) {
        const int d = imin(left, WF_DEPTH);
        const int nodes = (1 << d) - 1;
        bool ok = false;
        if (lane < nodes) {
          const int mid = node_mid(lo, hi, lane);
          unsigned sum = 0;
          for (int v = 0; v < V; ++v) {
            if (s_wadm[v]) sum += (unsigned)imin(imax(wsub(mid, s_wcnt[v]), 0), s_wcap[v]);
          }
          ok = (int)sum <= mq;
        }
        walk(&lo, &hi, d, __ballot_sync(FULL, ok));
      }
      const int L = lo;
      unsigned fsum = 0;
      for (int v = lane; v < V; v += 32) {
        if (s_wadm[v]) fsum += (unsigned)imin(imax(wsub(L, s_wcnt[v]), 0), s_wcap[v]);
      }
      const int rleft = wsub(mq, (int)warp_sum(fsum));
      m = 0;
      if (sub_value >= 0) {
        const int q = imin(sub_value, V - 1);
        auto fill_of = [&](int v) {
          return s_wadm[v] ? imin(imax(wsub(L, s_wcnt[v]), 0), s_wcap[v]) : 0;
        };
        auto elig_of = [&](int v) {
          const int f = fill_of(v);
          return s_wadm[v] && f < s_wcap[v] && wadd(s_wcnt[v], f) == L;
        };
        const bool eq = elig_of(q);
        const int rq = eq ? s_wrank[q] : RANK_NONE;
        unsigned erank = 0;
        for (int u = lane; u < V; u += 32) {
          const bool eu = elig_of(u);
          const int ru = eu ? s_wrank[u] : RANK_NONE;
          erank += (eu && ru < rq) ? 1u : 0u;
        }
        erank = warp_sum(erank);
        m = wadd(fill_of(q), (eq && (int)erank < rleft) ? 1 : 0);
      }
    }
    if (lane == 0) {
      a.sc[SC_M] = m;
      a.sc[SC_CARRY0] = carry0;
    }
  } else if (warp == 1) {
    // fresh-slot cap from owned hostname groups (lanes over groups)
    int fcap = INT_MAX;
    bool single = false;
    for (int g = lane; g < Gh; g += 32) {
      const bool boot = a.hboot[g];
      const int type = a.h_type[g];
      int f = type == 0 ? (h_sel[g] ? a.h_skew[g] : BIGI)
              : type == 1 ? (h_sel[g] ? 1 : BIGI)
                          : (boot ? BIGI : 0);
      if (!h_owner[g]) f = BIGI;
      fcap = imin(fcap, f);
      single = single || (boot && h_owner[g]);
    }
    fcap = warp_min(fcap);
    single = __any_sync(FULL, single);
    if (lane == 0) {
      a.sc[SC_FRESH_CAP] = imax(fcap, 0);
      a.sc[SC_SINGLE] = single ? 1 : 0;
      a.sc[SC_S] = s;
    }
  }

}

// the fresh-slot rows of type t for the step's template (k_fresh, the
// count a fresh slot fits, and off_fresh, its offering check), which only
// the merge reads: they run in the feasibility stage, off the prologue
__device__ __forceinline__ void fresh_row(const FfdArgs& a, int j, int t) {
  const int K = a.K, V = a.V, R = a.R;
  const int s = imax(ro(a.c_new_template + j), 0);
  const float* creq = a.c_requests + (size_t)j * R;
  const float* oh = a.t_overhead + (size_t)s * R;
  const int zk = ro(a.zone_key), ck = ro(a.ct_key);
  const int VB = V >> 3;
  const uint8_t* tm = a.t_mask + (size_t)s * K * VB;
  const unsigned long long zb = row_bits(tm + zk * VB, a.eff + zk * VB, a.Z, VB);
  const unsigned long long cb = row_bits(tm + ck * VB, a.eff + ck * VB, a.CT, VB);
  float kr = __int_as_float(0x7f800000);
  for (int r = 0; r < R; ++r) {
    const float al = ro(a.it_alloc + (size_t)t * R + r);
    const float c = ro(creq + r), o = ro(oh + r);
    const float h = c > 0.f ? __fdiv_rn(__fsub_rn(al, o), c)
                            : (al >= o ? BIGF : -1.0f);
    kr = fminf(kr, h);
  }
  a.k_fresh[t] = floorf(kr);
  a.off_fresh[t] = offering_ok(a, t, zb, cb);
}

// ---------------------------------------------------------------------------
// the slot stages' work items: (problem, slot, part) for the slots below the
// open bound, each slot's instance types cut into `parts` contiguous ranges
// of whole warps' worth, as many as the resident warps allow (up to TU types
// a lane)

__device__ __forceinline__ int parts_of(int T, long long slots,
                                        long long warps) {
  const int most = imax((T + 32 * TU - 1) / (32 * TU), 1);
  const long long fit = slots > 0 ? warps / slots : most;
  return (int)(fit < 1 ? 1 : (fit < most ? fit : most));
}

// the types [lo, hi) of part q of `parts`
__device__ __forceinline__ void part_range(int T, int q, int parts, int* lo,
                                           int* hi) {
  const int per = ((T + parts - 1) / parts + 31) & ~31;
  *lo = imin(q * per, T);
  *hi = imin(*lo + per, T);
}

__device__ __forceinline__ int clamp_k(float k) {
  return (int)fminf(fmaxf(k, 0.0f), 1073741824.0f);
}

// what the requirement rule of key k reads besides the value rows: slot
// n's requirement of the key and the step's effective class requirement
struct KeyRow {
  bool defines, complement, negative, edef, econc, eneg, well_known;
  int gt, lt, cgt, clt;
};

__device__ __forceinline__ KeyRow key_row(const FfdArgs& a, int j, int n,
                                          int k) {
  const int K = a.K, VB = a.V >> 3;
  const uint8_t* effd = a.eff + K * VB;
  const size_t nk = (size_t)n * K + k;
  KeyRow r;
  r.defines = a.defines[nk];
  r.complement = a.complement[nk];
  r.negative = a.negative[nk];
  r.gt = a.gt[nk];
  r.lt = a.lt[nk];
  r.edef = effd[k];
  r.econc = effd[K + k];
  r.eneg = effd[2 * K + k];
  r.cgt = ro(a.c_gt + (size_t)j * K + k);
  r.clt = ro(a.c_lt + (size_t)j * K + k);
  r.well_known = ro(a.well_known + k);
  return r;
}

// the requirement rule of a key (ops/ffd.py _class_slot_compatible): true
// when it bars the slot; `overlap`: the two value rows share a value
__device__ __forceinline__ bool key_bars(const KeyRow& r, bool overlap,
                                         int kind) {
  const bool both = r.defines && r.edef;
  const bool either_conc = !r.complement || r.econc;
  const bool crossed = imax(r.gt, r.cgt) >= imin(r.lt, r.clt);
  const bool empty = either_conc ? !overlap : crossed;
  const bool both_neg = r.negative && r.eneg;
  const bool rule2 = both && empty && !both_neg;
  const bool allow = r.well_known && kind == 2;
  const bool rule1 = r.edef && !r.eneg && !r.defines && !allow;
  return rule1 || rule2;
}

// one round of the packed requirement rows: units base + lane of slot n's
// K x VB bytes in ub-byte units (upk a key), each key's overlap ORed over
// its lanes, the rule applied by its leading lane; `acc` carries a key's
// overlap across rounds when it spans several (upk > 32). True when a key
// of the round bars the slot on this lane.
__device__ __forceinline__ bool req_round(const FfdArgs& a, int j, int n,
                                          int kind, int base, int lane,
                                          bool* acc) {
  const int K = a.K, VB = a.V >> 3;
  const int ub = VB < 32 ? VB : 32;
  const int upk = VB / ub;
  const int units = K * upk;
  const int u = base + lane;
  // every load of the round before any is used: the unit pair, and on
  // every lane with a unit the key row of its key (the leading lane uses
  // it; loading it on all of them keeps the loads ahead of the shuffles)
  const int k = imin((upk <= 32 ? u : base) / upk, K - 1);
  const bool lead = upk <= 32 ? u < units && (lane & (upk - 1)) == 0
                              : lane == 0 && ((base + 32) & (upk - 1)) == 0;
  KeyRow row{};
  if (u < units) row = key_row(a, j, n, k);
  bool overlap = u < units &&
                 unit_overlap(a.valmask + (size_t)n * K * VB + (size_t)u * ub,
                              a.eff + u * ub, ub);
  if (upk <= 32) {
    for (int o = 1; o < upk; o <<= 1) {
      overlap = overlap | (__shfl_xor_sync(FULL, (int)overlap, o) != 0);
    }
  } else {  // this round is part of key base / upk's row
    *acc = *acc || __any_sync(FULL, overlap);
    overlap = *acc;
    if (((base + 32) & (upk - 1)) == 0) *acc = false;
  }
  return lead && key_bars(row, overlap, kind);
}

// ---------------------------------------------------------------------------
// 2. slot feasibility: part 0 of a slot decides requirement compatibility,
// taints, the hostname caps and (existing slots) the fixed capacity into fc
// and kv; every part takes its types' best count into kv by atomicMax (new
// slots). The decisions combine them into k_eff.

__device__ __forceinline__ void feasible(const FfdArgs& a, int j, int n,
                                         int q, int parts, int lane) {
  const int K = a.K, V = a.V, T = a.T, R = a.R, Gh = a.Gh;
  const int VB = V >> 3;
  const float* creq = a.c_requests + (size_t)j * R;
  const float* req = reqs(a, j) + (size_t)n * R;
  // the slot's keys, and part 0's loads that do not depend on them
  const int kind = a.kind[n];
  const int tm = imax(a.tmpl[n], 0);

  if (q == 0) {
    // part 0 issues the first round of its loads (the packed rows, the key
    // rows, a hostname group a lane, a resource a lane) before the kind is
    // known: a pad slot (kind 0) is rare below the open bound and stores
    // nothing. Then the rounds past the first, when the rows need them.
    // (lanes past Gh or R load group or resource 0, and use neither)
    const bool exist_ok = ro(a.c_exist_taint_ok + (size_t)j * a.N + n) != 0;
    const bool hv = lane < Gh, rv = lane < R;
    const int g = hv ? lane : 0, r = rv ? lane : 0;
    const int hc = hv ? a.hcount[(size_t)n * Gh + g] : 0;
    const bool hsel = hv && ro(a.c_h_sel + (size_t)j * Gh + g) != 0;
    const bool hown = hv && ro(a.c_h_owner + (size_t)j * Gh + g) != 0;
    const int hskew = hv ? ro(a.h_skew + g) : 0;
    const int htype = hv ? ro(a.h_type + g) : 0;
    const bool hboot = hv && a.hboot[g] != 0;
    const float cap_r = rv ? a.capacity[(size_t)n * R + r] : 0.f;
    const float req_r = rv ? req[r] : 0.f;
    const float creq_r = rv ? ro(creq + r) : 0.f;
    bool acc = false;
    bool bad = req_round(a, j, n, kind, 0, lane, &acc);
    const bool tmpl_ok = kind == 2 && ro(a.c_tmpl_ok + (size_t)j * a.S + tm) != 0;
    if (kind == 0) return;  // pad slots never take (the decisions know)
    for (int base = 32; base < K * (VB < 32 ? 1 : VB / 32); base += 32) {
      bad = bad || req_round(a, j, n, kind, base, lane, &acc);
    }
    const bool req_ok = !__any_sync(FULL, bad);
    const bool taint_ok = kind == 1 ? exist_ok : tmpl_ok;
    // the hostname caps: groups lane, lane + 32, ...
    auto host_cap = [&](int c, bool sel, bool own, int skew, int type,
                        bool boot) {
      int cg;
      if (type == 0) {
        cg = sel ? wsub(skew, c) : (c <= skew ? BIGI : 0);
      } else if (type == 1) {
        cg = c == 0 ? (sel ? 1 : BIGI) : 0;
      } else {
        cg = boot ? BIGI : (c > 0 ? BIGI : 0);
      }
      return own ? cg : BIGI;
    };
    int cap = hv ? host_cap(hc, hsel, hown, hskew, htype, hboot) : INT_MAX;
    for (int g2 = lane + 32; g2 < Gh; g2 += 32) {
      cap = imin(cap, host_cap(a.hcount[(size_t)n * Gh + g2],
                               ro(a.c_h_sel + (size_t)j * Gh + g2) != 0,
                               ro(a.c_h_owner + (size_t)j * Gh + g2) != 0,
                               ro(a.h_skew + g2), ro(a.h_type + g2),
                               a.hboot[g2] != 0));
    }
    cap = imax(warp_min(cap), 0);
    // an existing node's count is its fixed capacity's: min over the
    // resources (a resource a lane) of (capacity - requests) / class
    // request where that is > 0, else BIG; min is exact in any order
    if (kind == 1) {
      float ke = __int_as_float(0x7f800000);
      if (rv) {
        ke = creq_r > 0.f ? __fdiv_rn(__fsub_rn(cap_r, req_r), creq_r) : BIGF;
      }
      for (int r2 = lane + 32; r2 < R; r2 += 32) {
        const float c = ro(creq + r2);
        ke = fminf(ke, c > 0.f ? __fdiv_rn(__fsub_rn(a.capacity[(size_t)n * R + r2],
                                                     req[r2]), c)
                               : BIGF);
      }
      for (int o = 16; o > 0; o >>= 1) {
        ke = fminf(ke, __shfl_xor_sync(FULL, ke, o));
      }
      if (lane == 0) a.kv[n] = clamp_k(floorf(ke));
    }
    if (lane == 0) a.fc[n] = (req_ok && taint_ok) ? cap : -1;
  }

  // this part's instance types: viable (itmask, class, offering) and the
  // count that fits; existing slots do not use them here (kind 1's count
  // is its capacity's)
  if (kind != 2) return;
  const int zk = ro(a.zone_key), ck = ro(a.ct_key);
  unsigned long long zb, cb;
  joined_zone_ct(a, n, zk, ck, a.eff, a.eff + K * VB, &zb, &cb);
  const uint8_t* cit = a.c_class_it + (size_t)j * T;
  const uint8_t* itm = a.itmask + (size_t)n * T;
  int lo, hi;
  part_range(T, q, parts, &lo, &hi);
  int best = -1;
  for (int t0 = lo + lane; t0 < hi; t0 += 32 * TU) {
    bool ok[TU];
    float kr[TU];
    types_at(a, t0, hi, itm, cit, zb, cb, req, creq, ok, kr);
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (ok[u]) best = imax(best, clamp_k(kr[u]));
    }
  }
  best = warp_max(best);
  if (lane == 0 && best >= 0) atomicMax(a.kv + n, best);
}

// ---------------------------------------------------------------------------
// 3. cross-slot decisions (one block per problem); thread tid owns the
// contiguous slots [n0, n1), so thread order is slot order

__device__ __forceinline__ void decide(const FfdArgs& a, int j, Red& red,
                                       unsigned char* region) {
  const int N = a.N;
  const int tid = threadIdx.x;
  const int chunk = (N + THREADS - 1) / THREADS;
  const int n0 = imin(tid * chunk, N);
  const int n1 = imin(n0 + chunk, N);

  const int m = a.sc[SC_M];
  const int carry0 = a.sc[SC_CARRY0];
  const int fresh_cap = a.sc[SC_FRESH_CAP];
  const bool single = a.sc[SC_SINGLE] != 0;
  const int nf = *a.next_free;
  const bool overflow0 = *a.overflow != 0;

  // each slot's record (k_eff and feasibility from the parts' fc and kv,
  // podcount, kind, take) in shared memory when N allows (decide_bytes),
  // else in the scratch planes; written by coalesced loads, kv reset for the
  // next step
  __syncthreads();  // the region may still hold the last problem's rows
  int2* wf_smem = (int2*)region;
  const bool staged = N <= STAGE_MAX;
  const int P = staged_slots(N);
  int* s_ke = (int*)(region + wf_smem_entries(N) * (int)sizeof(int2));
  int* s_pc = s_ke + P;
  int* s_take = s_pc + P;
  int8_t* s_kind = (int8_t*)(s_take + P);
  uint8_t* s_feas = (uint8_t*)(s_kind + P);
  // where slot n's record is
  auto at = [&](int n) { return staged ? (n % chunk) * THREADS + n / chunk : n; };
  int* ke_of = staged ? s_ke : a.k_eff;
  uint8_t* feas_of = staged ? s_feas : a.feas;
  const int* pc_of = staged ? s_pc : a.podcount;
  const int8_t* kind_of = staged ? s_kind : a.kind;
  int* take_of = staged ? s_take : a.take;
  constexpr int SU = 8;  // slots a thread loads at once
  for (int n0 = tid; n0 < N; n0 += SU * THREADS) {
    int kind[SU], pc[SU], kv[SU], fc[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int n = imin(n0 + u * THREADS, N - 1);
      kind[u] = a.kind[n];
      pc[u] = a.podcount[n];
      kv[u] = a.kv[n];
      fc[u] = a.fc[n];
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int n = n0 + u * THREADS;
      if (n >= N) break;
      a.kv[n] = -1;
      const bool fe = kind[u] != 0 && fc[u] >= 0 && (kind[u] == 1 || kv[u] >= 0);
      const int i = at(n);
      ke_of[i] = fe ? imin(kv[u], fc[u]) : 0;
      feas_of[i] = fe;
      if (staged) {
        s_pc[i] = pc[u];
        s_kind[i] = (int8_t)kind[u];
      }
    }
  }
  __syncthreads();

  // one pass: existing capacity for the prefix (per network level when
  // the step carries a topo_rank row), the in-flight slots that can take
  // (cap > 0), their fullest podcount, the first feasible slot
  const int32_t* topo =
      a.c_topo_rank != nullptr ? a.c_topo_rank + (size_t)j * N : nullptr;
  int lv[TOPO_LEVELS] = {0, 0, 0, 0};
  int exist = 0, claims = 0, hmax = INT_MIN, first_local = N;
  for (int n = n0; n < n1; ++n) {
    const int i = staged ? (n - n0) * THREADS + tid : n;
    const int kind = kind_of[i];
    const int ke = ke_of[i];
    if (kind == 1) exist = wadd(exist, ke);
    if (topo != nullptr && kind == 1) level_add(lv, topo_level(topo, n), ke);
    const int cap = kind == 2 ? ke : 0;
    claims += cap > 0 ? 1 : 0;
    hmax = imax(hmax, cap > 0 ? pc_of[i] : 0);
    if (feas_of[i] && first_local == N) first_local = n;
  }
  const Scan2 s1 = block_scan2(exist, claims, hmax, first_local, red);
  const int first = s1.mn;
  // the in-flight slots' (podcount, cap) in slot order: thread tid's are
  // entries [s1.ex1, s1.ex1 + claims)
  int2* wf = s1.tot1 <= WF_SMEM ? wf_smem : (int2*)a.wf;

  // level-grouped first-fit (rack-aware gangs): a slot's prefix is every
  // lower level's total plus the capacity before it in its own level; the
  // thread's running sums start at its block-exclusive offsets
  if (topo != nullptr) {
    const Scan4 s4 = block_scan4(lv, red);
    int below = 0;
#pragma unroll
    for (int l = 0; l < TOPO_LEVELS; ++l) {
      lv[l] = wadd(below, s4.ex[l]);
      below = wadd(below, s4.tot[l]);
    }
  }

  // existing slots first-fit in slot order (exclusive prefix)
  int run = s1.ex0, te_sum = 0, w_at = s1.ex1;
  for (int n = n0; n < n1; ++n) {
    const int i = staged ? (n - n0) * THREADS + tid : n;
    const int kind = kind_of[i];
    const int ke = ke_of[i];
    const int kx = kind == 1 ? ke : 0;
    int before = run;
    run = wadd(run, kx);
    if (topo != nullptr) {
      const int l = topo_level(topo, n);
      before = level_get(lv, l);
      level_add(lv, l, kx);
    }
    const int te = imin(imax(wsub(m, before), 0), kx);
    take_of[i] = te;
    te_sum = wadd(te_sum, te);
    if (kind == 2 && ke > 0) wf[w_at++] = make_int2(pc_of[i], ke);
  }
  // (this barrier also publishes the list)
  const int rem_claims = wsub(m, block_sum(te_sum, red));

  // in-flight claims emptiest-first: level_iters rounds of the binary
  // search for the water-fill level, DEPTH rounds a block barrier (warp w
  // sums the fill over the list at node w's midpoint)
  const int n_wf = s1.tot1;
  int hi = wadd(s1.mx, rem_claims);
  int lo = 0;
  {
    const int lane = tid & 31, w = tid >> 5;
    for (int left = a.level_iters; left > 0; left -= DEPTH) {
      const int d = imin(left, DEPTH);
      const int nodes = (1 << d) - 1;
      int* p = red.next();
      if (w < nodes) {
        const int mid = node_mid(lo, hi, w);
        unsigned sum = 0;
#pragma unroll 4
        for (int i = lane; i < n_wf; i += 32) {
          const int2 e = wf[i];
          sum += (unsigned)imin(imax(wsub(mid, e.x), 0), e.y);
        }
        sum = warp_sum(sum);
        if (lane == 0) p[w] = (int)sum <= rem_claims;
      }
      __syncthreads();
      walk(&lo, &hi, d, __ballot_sync(FULL, lane < nodes && p[imin(lane, nodes - 1)]));
    }
  }
  const int L = lo;
  int fsum = 0, ecount = 0;
  for (int i = s1.ex1; i < s1.ex1 + claims; ++i) {
    const int2 e = wf[i];
    const int f = imin(imax(wsub(L, e.x), 0), e.y);
    fsum = wadd(fsum, f);
    ecount += (f < e.y && wadd(e.x, f) == L) ? 1 : 0;
  }
  const Scan2 s2 = block_scan2(ecount, fsum, INT_MIN, INT_MAX, red);
  const int rleft = wsub(rem_claims, s2.tot1);
  int erank = s2.ex0;

  // take_exist + take_claims, then the single-slot (affinity bootstrap)
  // rule
  int tsum = 0;
  w_at = s1.ex1;
  for (int n = n0; n < n1; ++n) {
    const int i = staged ? (n - n0) * THREADS + tid : n;
    const int kind = kind_of[i];
    const int ke = ke_of[i];
    int t = take_of[i];
    if (kind == 2 && ke > 0) {
      const int2 e = wf[w_at++];
      const int f = imin(imax(wsub(L, e.x), 0), e.y);
      const bool elig = f < e.y && wadd(e.x, f) == L;
      t = wadd(t, f + ((elig && erank < rleft) ? 1 : 0));
      erank += elig ? 1 : 0;
    }
    if (single) t = n == first ? imin(ke, m) : 0;
    take_of[i] = t;
    tsum = wadd(tsum, t);
  }
  tsum = block_sum(tsum, red);

  // the fresh range; takes out in slot-strided (coalesced) order
  const int rem = wsub(m, tsum);
  const int new_tmpl = a.c_new_template[j];
  const bool has_template = new_tmpl >= 0 && fresh_cap > 0;
  const int kstar = imax(imin(imax(a.c_kstar[j], 1), fresh_cap), 1);
  int n_new = (has_template && rem > 0) ? (rem + kstar - 1) / kstar : 0;
  if (single) n_new = tsum > 0 ? 0 : imin(n_new, 1);
  const long long fresh_end = (long long)nf + n_new;
  int tfsum = 0;
  for (int n = tid; n < N; n += THREADS) {
    int tf = 0;
    if (n >= nf && (long long)n < fresh_end) {
      tf = imin(imax(wsub(rem, (n - nf) * kstar), 0), kstar);
    }
    a.takes[(size_t)j * N + n] = wadd(take_of[at(n)], tf);
    tfsum = wadd(tfsum, tf);
  }
  tfsum = block_sum(tfsum, red);
  if (tid == 0) {
    const int unplaced_step = wsub(rem, tfsum);
    const int placed = wsub(m, unplaced_step);
    const int carry_after = wsub(carry0, placed);
    const bool is_wf = a.c_wf_group[j] >= 0;
    a.unplaced[j] = is_wf ? (a.c_sub_last[j] ? carry_after : 0) : unplaced_step;
    *a.carry = carry_after;
    *a.next_free = wadd(nf, n_new);
    *a.overflow = (overflow0 || fresh_end > (long long)N) ? 1 : 0;
    // the fresh slots join the open range of the slot stages
    atomicMax(a.open, (int)(fresh_end < (long long)N ? fresh_end : N));
    a.sc[SC_NF_OLD] = nf;
    a.sc[SC_NNEW] = n_new;
  }
}

// ---------------------------------------------------------------------------
// 4. slot merge: every part of a joined slot updates its types' itmask, and
// part 0 the rest of the slot; the slots that did not join only carry their
// requests over (merge_requests)

// whether slot n joined at step j: it is fresh, or took pods (a slot that
// is not fresh took exactly its takes entry, no fresh share)
__device__ __forceinline__ bool joined(const FfdArgs& a, int j, int n) {
  const int nf = a.sc[SC_NF_OLD];
  const int nn = a.sc[SC_NNEW];
  const bool fresh = n >= nf && (long long)n < (long long)nf + nn;
  return fresh || a.takes[(size_t)j * a.N + n] > 0;
}

// merge item (slot n, part q); nothing for a slot that did not join
__device__ __forceinline__ void merge(const FfdArgs& a, int j, int n, int q,
                                      int parts, int lane) {
  const int K = a.K, V = a.V, T = a.T, R = a.R;
  const int nf = a.sc[SC_NF_OLD];
  const int nn = a.sc[SC_NNEW];
  const bool fresh = n >= nf && (long long)n < (long long)nf + nn;
  const int tk = a.takes[(size_t)j * a.N + n];
  // a slot that is not fresh took exactly its takes entry (no fresh share)
  if (!(fresh || tk > 0)) return;
  const int s = a.sc[SC_S];
  const float tkf = (float)tk;
  const float* creq = a.c_requests + (size_t)j * R;
  const float* req = reqs(a, j) + (size_t)n * R;
  const int VB = V >> 3;
  const uint8_t* effm = a.eff;
  const uint8_t* effd = a.eff + K * VB;
  const uint8_t* cit = a.c_class_it + (size_t)j * T;
  uint8_t* itm = a.itmask + (size_t)n * T;

  // itmask over this part's types, from the pre-merge planes and requests
  int lo, hi;
  part_range(T, q, parts, &lo, &hi);
  if (fresh) {
    const uint8_t* tit = a.t_it + (size_t)s * T;
#pragma unroll 8
    for (int t = lo + lane; t < hi; t += 32) {
      itm[t] = (tit[t] != 0) & (cit[t] != 0) & (a.k_fresh[t] >= tkf) &
               (a.off_fresh[t] != 0);
    }
  } else {
    unsigned long long zb, cb;
    joined_zone_ct(a, n, ro(a.zone_key), ro(a.ct_key), effm, effd, &zb, &cb);
    for (int t0 = lo + lane; t0 < hi; t0 += 32 * TU) {
      bool ok[TU];
      float kr[TU];
      types_at(a, t0, hi, itm, cit, zb, cb, req, creq, ok, kr);
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        if (t0 + 32 * u < hi) itm[t0 + 32 * u] = ok[u] && kr[u] >= tkf;
      }
    }
  }
  if (q != 0) return;
  __syncwarp();

  // requirement planes: intersect-on-add over the keys the class defines,
  // on the packed rows (8-byte words where a row has them)
  const uint8_t* effc = effd + K;
  const uint8_t* effn = effc + K;
  if (VB >= 8) {
    unsigned long long* vm = (unsigned long long*)(a.valmask + (size_t)n * K * VB);
    const unsigned long long* tm =
        (const unsigned long long*)(a.t_mask + (size_t)s * K * VB);
    const unsigned long long* em = (const unsigned long long*)effm;
    for (int w = lane; w < K * VB / 8; w += 32) {
      unsigned long long base = fresh ? ro(tm + w) : vm[w];
      if (effd[w * 8 / VB]) base &= em[w];
      vm[w] = base;
    }
  } else {
    uint8_t* vm = a.valmask + (size_t)n * K * VB;
    const uint8_t* tm = a.t_mask + (size_t)s * K * VB;
    for (int i = lane; i < K * VB; i += 32) {
      unsigned base = fresh ? ro(tm + i) : vm[i];
      if (effd[i / VB]) base &= effm[i];
      vm[i] = (uint8_t)base;
    }
  }
  const int* cgt = a.c_gt + (size_t)j * K;
  const int* clt = a.c_lt + (size_t)j * K;
  for (int k = lane; k < K; k += 32) {
    const size_t nk = (size_t)n * K + k;
    const size_t sk = (size_t)s * K + k;
    const bool upd = effd[k];
    const bool bd = fresh ? a.t_defines[sk] != 0 : a.defines[nk] != 0;
    const bool bc = fresh ? a.t_complement[sk] != 0 : a.complement[nk] != 0;
    const bool bn = fresh ? a.t_negative[sk] != 0 : a.negative[nk] != 0;
    const int bg = fresh ? a.t_gt[sk] : a.gt[nk];
    const int bl = fresh ? a.t_lt[sk] : a.lt[nk];
    a.defines[nk] = bd || upd;
    a.complement[nk] = upd ? (bc && !effc[k]) : bc;
    a.negative[nk] = upd ? (bn && effn[k]) : bn;
    a.gt[nk] = upd ? imax(bg, cgt[k]) : bg;
    a.lt[nk] = upd ? imin(bl, clt[k]) : bl;
  }
  float* req_next = reqs(a, j + 1) + (size_t)n * R;
  for (int r = lane; r < R; r += 32) {
    const float base = fresh ? a.t_overhead[(size_t)s * R + r] : req[r];
    req_next[r] = __fadd_rn(base, __fmul_rn(tkf, creq[r]));
    if (fresh) a.capacity[(size_t)n * R + r] = BIGF;
  }
  // hostname counts, and the per-group flag of a positive count (counts
  // never fall: tk >= 0)
  for (int g = lane; g < a.Gh; g += 32) {
    if (a.c_h_sel[(size_t)j * a.Gh + g]) {
      const int c = wadd(a.hcount[(size_t)n * a.Gh + g], tk);
      a.hcount[(size_t)n * a.Gh + g] = c;
      if (c > 0) a.hflag[g] = 1;
    }
  }
  if (lane == 0) {
    if (fresh) {
      a.kind[n] = 2;
      a.tmpl[n] = s;
    }
    a.podcount[n] = wadd(a.podcount[n], tk);
  }
  __syncwarp();

  // label-group counts: pinned rows (spread/affinity) or every value the
  // slot could take (anti-affinity)
  if (tk != 0) {
    for (int g = lane; g < a.Gz; g += 32) {
      if (!a.c_z_sel[(size_t)j * a.Gz + g]) continue;
      const int k = a.z_key[g];
      const size_t nk = (size_t)n * K + k;
      if (!(a.defines[nk] && !a.complement[nk])) continue;
      const uint8_t* row = a.valmask + nk * VB;
      int rc = 0;
      for (int i = 0; i < VB; i += 8) rc += __popcll(word_at(row + i, VB - i));
      if (a.z_type[g] != 1 && rc != 1) continue;
      for (int i = 0; i < VB; i += 8) {  // the row's set values, in order
        for (unsigned long long x = word_at(row + i, VB - i); x != 0ull;
             x &= x - 1ull) {
          const int v = 8 * i + __ffsll((long long)x) - 1;
          atomicAdd(a.zcount + (size_t)g * V + v, tk);
        }
      }
    }
  }
}

__device__ __noinline__ void merge_out_of_line(const FfdArgs& a, int j, int n,
                                               int q, int parts, int lane) {
  merge(a, j, n, q, parts, lane);
}

// requests = requests + 0 * r for every slot that did not join, as in the
// plain version (takes[j, n] is 0 there), one element per thread
__device__ __forceinline__ void merge_requests(const FfdArgs& args, int j,
                                               long long e) {
  const int N = args.N, R = args.R;
  const long long per = (long long)N * R;
  const FfdArgs a = problem(args, (int)(e / per));
  const int n = (int)(e % per) / R, r = (int)(e % R);
  const int nf = a.sc[SC_NF_OLD];
  const int nn = a.sc[SC_NNEW];
  const bool fresh = n >= nf && (long long)n < (long long)nf + nn;
  const int tk = a.takes[(size_t)j * N + n];
  if (fresh || tk > 0) return;
  const size_t i = (size_t)n * R + r;
  reqs(a, j + 1)[i] = __fadd_rn(reqs(a, j)[i],
                                __fmul_rn((float)tk, a.c_requests[(size_t)j * R + r]));
}

// ---------------------------------------------------------------------------
// the scan: J steps of four stages for all B problems, grid barriers between

__global__ void __launch_bounds__(THREADS, 1) k_ffd_scan(FfdArgs args) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Red red{(int*)smem_raw, 0};
  unsigned char* region = smem_raw + RED_BYTES;
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)G * WARPS;
  // warp rank, blocks interleaved; a thread's rank likewise
  const long long rank = (long long)(threadIdx.x >> 5) * G + blockIdx.x;
  const long long trank = rank * 32 + lane, threads = warps * 32;
  const int N = args.N, B = args.B, T = args.T;

  // scan start: the open bound, which hostname groups have a positive count
  // on some slot, and the zones of each (type, capacity type) with an
  // available offering
  for (long long e = trank; e < (long long)B * N; e += threads) {
    if (args.kind[e] != 0) atomicMax(args.open, (int)(e % N) + 1);
  }
  const long long hcells = (long long)B * N * args.Gh;
  for (long long e = trank; e < hcells; e += threads) {
    if (args.hcount[e] > 0) {
      const long long b = e / ((long long)N * args.Gh);
      args.hflag[b * args.Gh + e % args.Gh] = 1;
    }
  }
  const long long ocells = (long long)B * T * args.CT;
  for (long long e = trank; e < ocells; e += threads) {
    const long long bt = e / args.CT;
    const int c = (int)(e % args.CT);
    // problem bt / T's statics (one copy when they are shared), type bt % T
    const long long st = (bt / T) * args.static_stride * T + bt % T;
    const uint8_t* row = args.off_avail + st * args.Z * args.CT;
    unsigned long long zones = 0ull;
    for (int z = 0; z < args.Z; ++z) {
      if (row[z * args.CT + c]) zones |= 1ull << z;
    }
    args.offm[e] = zones;
  }
  grid.sync();

  for (int j = 0; j < args.J; ++j) {
    stamp(args, j, 0);
    for (int b = blockIdx.x; b < B; b += G) {
      prologue(problem(args, b), j, region);
    }
    grid.sync();
    stamp(args, j, 1);
    {
      const long long slots = (long long)B * *args.open;
      const int parts = parts_of(T, slots, warps);
      const int open = *args.open;
      for (long long i = rank; i < slots * parts; i += warps) {
        const long long sl = i / parts;
        feasible(problem(args, (int)(sl / open)), j, (int)(sl % open),
                 (int)(i % parts), parts, lane);
      }
      // the fresh-slot rows, from the highest thread ranks down (the slot
      // items take the lowest warp ranks)
      for (long long e = threads - 1 - trank; e < (long long)B * T;
           e += threads) {
        fresh_row(problem(args, (int)(e / T)), j, (int)(e % T));
      }
    }
    grid.sync();
    stamp(args, j, 2);
    for (int b = blockIdx.x; b < B; b += G) {
      decide(problem(args, b), j, red, region);
    }
    grid.sync();
    stamp(args, j, 3);
    {
      const long long slots = (long long)B * *args.open;
      const int parts = parts_of(T, slots, warps);
      const int open = *args.open;
      if (slots * parts > MERGE_BATCH * warps) {
        // many items a warp (the sweep's B x open slots): a warp tests 32
        // of its items at a time, lane l whether the slot of item
        // i + l * warps joined (a fresh slot, or one that took), and
        // merges those items only, in item order, through an out-of-line
        // copy of the merge (few items join: its registers stay out of
        // the other routes' loop)
        for (long long i = rank; i < slots * parts; i += 32 * warps) {
          const long long il = i + lane * warps;
          bool join = false;
          if (il < slots * parts) {
            const long long sl = il / parts;
            join = joined(problem(args, (int)(sl / open)), j, (int)(sl % open));
          }
          for (unsigned m = __ballot_sync(FULL, join); m != 0u; m &= m - 1u) {
            const long long it = i + (long long)(__ffs(m) - 1) * warps;
            const long long sl = it / parts;
            merge_out_of_line(problem(args, (int)(sl / open)), j,
                              (int)(sl % open), (int)(it % parts), parts,
                              lane);
          }
        }
      } else {
        for (long long i = rank; i < slots * parts; i += warps) {
          const long long sl = i / parts;
          merge(problem(args, (int)(sl / open)), j, (int)(sl % open),
                (int)(i % parts), parts, lane);
        }
      }
      for (long long e = trank; e < (long long)B * N * args.R; e += threads) {
        merge_requests(args, j, e);
      }
    }
    grid.sync();
    stamp(args, j, 4);
  }
  // the last step's requests into the state's plane
  if (args.J & 1) {
    for (long long e = trank; e < (long long)B * N * args.R; e += threads) {
      args.requests[e] = args.req_alt[e];
    }
  }
}

}  // namespace

extern "C" {

int ffd_args_size() { return (int)sizeof(FfdArgs); }

// dynamic shared memory of a block at these widths
int ffd_scan_smem(int N, int K, int V, int Gz) {
  FfdArgs a{};
  a.N = N;
  a.K = K;
  a.V = V;
  a.Gz = Gz;
  return scan_smem(a);
}

// The whole scan of `args` (all B problems, all J class steps) as one
// cooperative launch on `stream`, with no host synchronisation. The grid is
// every block that fits on the device at once (the occupancy calculator x
// the SM count), or max_blocks if that is positive and smaller; the blocks
// launched go to *blocks. Returns 0 on success, else a cudaError_t.
int ffd_scan(const FfdArgs* args, int max_blocks, cudaStream_t stream,
             int* blocks) {
  FfdArgs a = *args;
  const int smem = scan_smem(a);
  cudaError_t rc = cudaFuncSetAttribute(
      (const void*)k_ffd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return (int)rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (!coop) return (int)cudaErrorNotSupported;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_ffd_scan, THREADS, smem);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  *blocks = grid;
  void* params[] = {&a};
  rc = cudaLaunchCooperativeKernel((const void*)k_ffd_scan, dim3(grid),
                                   dim3(THREADS), params, (size_t)smem,
                                   stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

const char* ffd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
