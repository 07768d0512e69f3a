// One first-fit-decreasing class step of the provisioning solve, for Hopper
// (sm_90a), for B independent problems at once.
//
// Replaces karpenter_core_tpu/ops/pallas_ffd.py::_fused_step (the
// pl.pallas_call at :135) on both of its routes: solo, and batched
// (batched=True, the vmap of ffd_step over a leading problem axis that
// _pallas_ffd_solve_batched_impl drives). Its body is ops/ffd.py::ffd_step;
// that function is this kernel's specification, and the port's plain
// version of it (karpenter_core_tpu_torch/ops/ffd.py) is its oracle. The
// problem axis B rides the grid: the slot-parallel kernels take a grid
// (warp blocks, B) with the problem b = blockIdx.y, the one-block kernels a
// grid (B) with b = blockIdx.x, and each block first offsets every pointer
// of FfdArgs to problem b's planes (problem(), 64-bit offsets), so each
// problem has its own state, class steps, statics, outputs and scratch. A
// solo scan is B = 1. The arithmetic is
// integer-exact float32: every division is IEEE round-to-nearest
// (__fdiv_rn), every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the build also passes -fmad=false), and the counts that JAX
// forms as float32 einsums are integer sums here.
//
// What bounds it: one step touches the slot state once (the [N,T] itmask
// dominates, ~11 MB at N=4096, T=1024), which the 50 MB L2 holds, so a step
// is bound by latency: the chain of dependent stages, the serial cross-slot
// decisions (an exclusive prefix and a binary-search water-fill over all
// slots), and launch overhead. The design keeps every stage on the device
// and the slot state in place, with no host synchronisation inside a step
// or between steps; the stages are four kernels, each with its own C entry
// (launch_<kernel>), launched in turn on one stream:
//   1. k_prologue, one block: the class's admissible-domain restriction,
//      host caps of a fresh slot, the water-fill quota over values, and the
//      [T] rows k_fresh / off_fresh for the chosen template;
//   2. k_feasible, one warp per slot: requirement compatibility, taints,
//      the offering check, k_max over viable instance types, slot caps;
//   3. k_decide, one block: first-fit over existing slots by an exclusive
//      block scan, emptiest-first water-fill over in-flight claims, the
//      single-slot rule, the fresh range, and the state scalars;
//   4. k_merge, one warp per slot: requirement planes, requests, itmask
//      (recomputing k_raw and the offering check for joined slots rather
//      than storing [N,T] floats), kind/template/capacity, podcount,
//      hcount; zcount deltas go in by integer atomicAdd (order-free).
// Fresh slots never write past N: an overflowing step fills [next_free, N)
// and raises the overflow flag, and the host retries with more slots.
// Batched, one class step is still four launches, whatever B is: the
// blocks of the B problems run side by side, so a step of B latency-bound
// problems costs about one step while the card has SMs to spare.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int BIGI = 1 << 30;
constexpr int RANK_NONE = 1 << 30;
constexpr float BIGF = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DECIDE_THREADS = 1024;
constexpr int WARP_BLOCK = 256;

// scalar scratch slots written by k_prologue / k_decide
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
// pointer is to problem 0 of B problems laid out one after another, each
// plane's per-problem size as the comments say.
struct FfdArgs {
  // slot state, updated in place
  uint8_t* valmask;     // [N,K,V]
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
  // solve statics
  const float* it_alloc;        // [T,R]
  const uint8_t* off_avail;     // [T,Z,CT]
  const int32_t* zone_key;      // []
  const int32_t* ct_key;        // []
  const uint8_t* t_mask;        // [S,K,V]
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
  uint8_t* eff;                 // [K*V + 3K]: mask, defines, concrete, negative
  uint8_t* hboot;               // [Gh]
  float* k_fresh;               // [T]
  uint8_t* off_fresh;           // [T]
  int32_t* k_eff;               // [N]
  uint8_t* feas;                // [N]
  int32_t* take;                // [N]
  // dims; B problems of J class steps each
  int32_t N, K, V, T, R, S, Z, CT, Gh, Gz, level_iters, B, J, pad_;
};

}  // extern "C"

namespace {

// the arguments with every pointer moved to problem b's planes
__device__ __forceinline__ FfdArgs problem(const FfdArgs& a, int b) {
  FfdArgs p = a;
  const size_t ub = (size_t)b;
  const size_t N = a.N, K = a.K, V = a.V, T = a.T, R = a.R, S = a.S;
  const size_t Gh = a.Gh, Gz = a.Gz, J = a.J;
  // slot state
  p.valmask += ub * N * K * V;
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
  // class steps
  p.c_mask += ub * J * K * V;
  p.c_defines += ub * J * K;
  p.c_concrete += ub * J * K;
  p.c_negative += ub * J * K;
  p.c_gt += ub * J * K;
  p.c_lt += ub * J * K;
  p.c_count += ub * J;
  p.c_requests += ub * J * R;
  p.c_class_it += ub * J * T;
  p.c_tmpl_ok += ub * J * S;
  p.c_exist_taint_ok += ub * J * N;
  p.c_new_template += ub * J;
  p.c_kstar += ub * J;
  p.c_smask += ub * J * K * V;
  p.c_h_sel += ub * J * Gh;
  p.c_h_owner += ub * J * Gh;
  p.c_z_sel += ub * J * Gz;
  p.c_z_owner += ub * J * Gz;
  p.c_sub_value += ub * J;
  p.c_sub_first += ub * J;
  p.c_sub_last += ub * J;
  p.c_wf_group += ub * J;
  p.c_wf_key += ub * J;
  p.c_zone_rest += ub * J * V;
  // statics
  p.it_alloc += ub * T * R;
  p.off_avail += ub * T * (size_t)a.Z * (size_t)a.CT;
  p.zone_key += ub;
  p.ct_key += ub;
  p.t_mask += ub * S * K * V;
  p.t_defines += ub * S * K;
  p.t_complement += ub * S * K;
  p.t_negative += ub * S * K;
  p.t_gt += ub * S * K;
  p.t_lt += ub * S * K;
  p.t_it += ub * S * T;
  p.t_overhead += ub * S * R;
  p.well_known += ub * K;
  p.h_type += ub * Gh;
  p.h_skew += ub * Gh;
  p.h_possel0 += ub * Gh;
  p.z_type += ub * Gz;
  p.z_skew += ub * Gz;
  p.z_key += ub * Gz;
  p.z_mindom += ub * Gz;
  p.z_domains += ub * Gz * V;
  p.z_rank += ub * Gz * V;
  // outputs
  p.takes += ub * J * N;
  p.unplaced += ub * J;
  // scratch
  p.sc += ub * SC_COUNT_;
  p.eff += ub * (K * V + 3 * K);
  p.hboot += ub * Gh;
  p.k_fresh += ub * T;
  p.off_fresh += ub * T;
  p.k_eff += ub * N;
  p.feas += ub * N;
  p.take += ub * N;
  return p;
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

// the class's joined zone / capacity-type rows of slot n as bitmasks
// (Z, CT <= 64, checked by the wrapper)
__device__ __forceinline__ void joined_zone_ct(const FfdArgs& a, int n,
                                               const uint8_t* effm,
                                               const uint8_t* effd,
                                               unsigned long long* zb,
                                               unsigned long long* cb) {
  const int K = a.K, V = a.V;
  const int zk = *a.zone_key, ck = *a.ct_key;
  unsigned long long z = 0ull, c = 0ull;
  for (int i = 0; i < a.Z; ++i) {
    bool bit = a.valmask[((size_t)n * K + zk) * V + i] &&
               (!effd[zk] || effm[zk * V + i]);
    if (bit) z |= 1ull << i;
  }
  for (int i = 0; i < a.CT; ++i) {
    bool bit = a.valmask[((size_t)n * K + ck) * V + i] &&
               (!effd[ck] || effm[ck * V + i]);
    if (bit) c |= 1ull << i;
  }
  *zb = z;
  *cb = c;
}

__device__ __forceinline__ bool offering_ok(const FfdArgs& a, int t,
                                            unsigned long long zb,
                                            unsigned long long cb) {
  const uint8_t* row = a.off_avail + (size_t)t * a.Z * a.CT;
  for (int z = 0; z < a.Z; ++z) {
    if (!((zb >> z) & 1ull)) continue;
    for (int c = 0; c < a.CT; ++c) {
      if (((cb >> c) & 1ull) && row[z * a.CT + c]) return true;
    }
  }
  return false;
}

// floor(min_r head) with head = (alloc - req) / r where r > 0, else BIG
__device__ __forceinline__ float k_raw_at(const FfdArgs& a, int t,
                                          const float* req,
                                          const float* creq) {
  float kr = __int_as_float(0x7f800000);  // +inf
  for (int r = 0; r < a.R; ++r) {
    float rr = creq[r];
    float h = rr > 0.f
                  ? __fdiv_rn(__fsub_rn(a.it_alloc[(size_t)t * a.R + r], req[r]),
                              rr)
                  : BIGF;
    kr = fminf(kr, h);
  }
  return floorf(kr);
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = imin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// block-wide reductions and scan over DECIDE_THREADS threads; sh holds >= 33
// ints and every thread of the block must call them
__device__ int block_sum(int x, int* sh) {
  unsigned v = (unsigned)x;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[w] = (int)v;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    unsigned t = lane < nw ? (unsigned)sh[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    if (lane == 0) sh[32] = (int)t;
  }
  __syncthreads();
  return sh[32];
}

__device__ int block_max(int x, int* sh) {
  int v = x;
  for (int o = 16; o > 0; o >>= 1) v = imax(v, __shfl_xor_sync(FULL, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    int t = lane < nw ? sh[lane] : INT_MIN;
    for (int o = 16; o > 0; o >>= 1) t = imax(t, __shfl_xor_sync(FULL, t, o));
    if (lane == 0) sh[32] = t;
  }
  __syncthreads();
  return sh[32];
}

__device__ int block_min(int x, int* sh) {
  return -block_max(-x, sh);
}

// exclusive prefix of x over threads in thread order (wrapping int32)
__device__ int block_excl_scan(int x, int* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned v = (unsigned)x;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned up = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += up;
  }
  __syncthreads();
  if (lane == 31) sh[w] = (int)v;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    unsigned s = lane < nw ? (unsigned)sh[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      unsigned up = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += up;
    }
    sh[lane] = (int)s;
  }
  __syncthreads();
  unsigned before = w > 0 ? (unsigned)sh[w - 1] : 0u;
  return (int)(before + v - (unsigned)x);
}

// ---------------------------------------------------------------------------
// 1. class prologue (one block per problem)

__global__ void k_prologue(FfdArgs args, int j) {
  const FfdArgs a = problem(args, blockIdx.x);
  const int K = a.K, V = a.V, Gz = a.Gz, Gh = a.Gh, T = a.T, R = a.R;
  extern __shared__ int smem[];
  int* s_pos = smem;                 // [Gh]
  int* s_wcnt = s_pos + Gh;          // [V]
  int* s_wcap = s_wcnt + V;          // [V]
  int* s_wrank = s_wcap + V;         // [V]
  int* s_wadm = s_wrank + V;         // [V]
  uint8_t* s_adm = (uint8_t*)(s_wadm + V);  // [Gz*V]
  uint8_t* s_effm = s_adm + Gz * V;         // [K*V]
  uint8_t* s_effd = s_effm + K * V;         // [K]
  uint8_t* s_effc = s_effd + K;             // [K]
  uint8_t* s_effn = s_effc + K;             // [K]

  const uint8_t* cmask = a.c_mask + (size_t)j * K * V;
  const uint8_t* smask = a.c_smask + (size_t)j * K * V;
  const uint8_t* z_sel = a.c_z_sel + (size_t)j * Gz;
  const uint8_t* z_owner = a.c_z_owner + (size_t)j * Gz;
  const uint8_t* h_sel = a.c_h_sel + (size_t)j * Gh;
  const uint8_t* h_owner = a.c_h_owner + (size_t)j * Gh;
  const int wf_group = a.c_wf_group[j];
  const int wf_key = a.c_wf_key[j];
  const int sub_value = a.c_sub_value[j];
  const int tid = threadIdx.x;

  for (int g = tid; g < Gh; g += blockDim.x) s_pos[g] = 0;
  __syncthreads();

  // label-group admissible domains, one thread per group
  for (int g = tid; g < Gz; g += blockDim.x) {
    const int zk = a.z_key[g];
    const uint8_t* dom = a.z_domains + (size_t)g * V;
    const int* cnt = a.zcount + (size_t)g * V;
    const int* rk = a.z_rank + (size_t)g * V;
    int minc = INT_MAX, supported = 0, minrank = INT_MAX;
    bool any_pos = false;
    for (int v = 0; v < V; ++v) {
      const bool padm = smask[zk * V + v] && dom[v];
      minc = imin(minc, padm ? cnt[v] : BIGI);
      supported += padm ? 1 : 0;
      any_pos = any_pos || (padm && cnt[v] > 0);
      minrank = imin(minrank, padm ? rk[v] : RANK_NONE);
    }
    if (a.z_mindom[g] >= 0 && supported < a.z_mindom[g]) minc = 0;
    const int inc = z_sel[g] ? 1 : 0;
    const int type = a.z_type[g];
    for (int v = 0; v < V; ++v) {
      const bool padm = smask[zk * V + v] && dom[v];
      const int c = cnt[v];
      bool adm;
      if (type == 0) {
        adm = padm && wsub(wadd(c, inc), minc) <= a.z_skew[g];
      } else if (type == 1) {
        adm = padm && c == 0;
      } else {
        const bool pos = padm && c > 0;
        const bool boot = padm && (padm ? rk[v] : RANK_NONE) == minrank;
        adm = any_pos ? pos : (z_sel[g] && boot);
      }
      s_adm[g * V + v] = adm;
    }
  }
  // hostname groups with a positive count on any slot
  for (int i = tid; i < a.N * Gh; i += blockDim.x) {
    if (a.hcount[i] > 0) s_pos[i % Gh] = 1;
  }
  __syncthreads();

  // effective class requirements: restriction by owned groups + wf pin
  const bool has_wf = wf_group >= 0;
  for (int e = tid; e < K * V; e += blockDim.x) {
    const int k = e / V, v = e % V;
    bool viol = false, topo_def = false;
    for (int g = 0; g < Gz; ++g) {
      if (!(z_owner[g] && g != wf_group && a.z_key[g] == k)) continue;
      topo_def = true;
      viol = viol || !s_adm[g * V + v];
    }
    bool restr = !viol;
    const bool pin_row = v == imax(sub_value, 0) && sub_value >= 0;
    const bool wf_oh = k == imax(wf_key, 0) && has_wf;
    restr = restr && (!wf_oh || pin_row);
    topo_def = topo_def || wf_oh;
    s_effm[e] = cmask[e] && restr;
    if (v == 0) {
      const size_t ck = (size_t)j * K + k;
      s_effd[k] = a.c_defines[ck] || topo_def;
      s_effc[k] = a.c_concrete[ck] || topo_def;
      s_effn[k] = a.c_negative[ck] && !topo_def;
    }
  }
  for (int g = tid; g < Gh; g += blockDim.x) {
    const bool pos_any = a.h_possel0[g] || s_pos[g];
    a.hboot[g] = !pos_any && h_sel[g] && a.h_type[g] == 2;
  }
  __syncthreads();
  for (int e = tid; e < K * V + 3 * K; e += blockDim.x) {
    a.eff[e] = e < K * V ? s_effm[e]
               : e < K * V + K ? s_effd[e - K * V]
               : e < K * V + 2 * K ? s_effc[e - K * V - K]
                                   : s_effn[e - K * V - 2 * K];
  }

  const int s = imax(a.c_new_template[j], 0);
  if (tid == 0) {
    // fresh-slot cap from owned hostname groups
    int fcap = INT_MAX;
    bool single = false;
    for (int g = 0; g < Gh; ++g) {
      const bool boot = a.hboot[g];
      const int type = a.h_type[g];
      int f = type == 0 ? (h_sel[g] ? a.h_skew[g] : BIGI)
              : type == 1 ? (h_sel[g] ? 1 : BIGI)
                          : (boot ? BIGI : 0);
      if (!h_owner[g]) f = BIGI;
      fcap = imin(fcap, f);
      single = single || (boot && h_owner[g]);
    }
    const int count = a.c_count[j];
    const int carry0 = a.c_sub_first[j] ? count : *a.carry;
    int m = count;
    if (has_wf) {
      // water-fill quota of the pinned sub-step domain (serial over V)
      const int g = imax(wf_group, 0);
      const int zk = a.z_key[g];
      const uint8_t* rest = a.c_zone_rest + (size_t)j * V;
      int supported = 0;
      for (int v = 0; v < V; ++v) {
        supported += (smask[zk * V + v] && a.z_domains[(size_t)g * V + v]) ? 1 : 0;
      }
      const int mindom = a.z_mindom[g];
      const bool unsat = mindom >= 0 && supported < mindom;
      for (int v = 0; v < V; ++v) {
        const int c = a.zcount[(size_t)g * V + v];
        s_wcnt[v] = c;
        s_wcap[v] = imax(unsat ? imax(wsub(a.z_skew[g], c), 0) : BIGI, 0);
        s_wrank[v] = a.z_rank[(size_t)g * V + v];
        s_wadm[v] = rest[v];
      }
      const int mq = carry0;
      int hi = INT_MIN;
      for (int v = 0; v < V; ++v) hi = imax(hi, s_wadm[v] ? s_wcnt[v] : 0);
      hi = wadd(hi, mq);
      int lo = 0;
      for (int it = 0; it < a.level_iters; ++it) {
        const int mid = wadd(wadd(lo, hi), 1) >> 1;
        int sum = 0;
        for (int v = 0; v < V; ++v) {
          if (s_wadm[v]) sum = wadd(sum, imin(imax(wsub(mid, s_wcnt[v]), 0), s_wcap[v]));
        }
        const bool ok = sum <= mq;
        lo = ok ? mid : lo;
        hi = ok ? hi : mid - 1;
      }
      const int L = lo;
      int fsum = 0;
      for (int v = 0; v < V; ++v) {
        if (s_wadm[v]) fsum = wadd(fsum, imin(imax(wsub(L, s_wcnt[v]), 0), s_wcap[v]));
      }
      const int rleft = wsub(mq, fsum);
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
        int erank = 0;
        for (int u = 0; u < V; ++u) {
          const bool eu = elig_of(u);
          const int ru = eu ? s_wrank[u] : RANK_NONE;
          erank += (eu && ru < rq) ? 1 : 0;
        }
        m = wadd(fill_of(q), (eq && erank < rleft) ? 1 : 0);
      }
    }
    a.sc[SC_M] = m;
    a.sc[SC_CARRY0] = carry0;
    a.sc[SC_FRESH_CAP] = imax(fcap, 0);
    a.sc[SC_SINGLE] = single ? 1 : 0;
    a.sc[SC_S] = s;
  }

  // fresh-slot rows over instance types for the chosen template
  const float* creq = a.c_requests + (size_t)j * R;
  const float* oh = a.t_overhead + (size_t)s * R;
  const int zk = *a.zone_key, ck = *a.ct_key;
  unsigned long long zb = 0ull, cb = 0ull;
  for (int i = 0; i < a.Z; ++i) {
    if (a.t_mask[((size_t)s * K + zk) * V + i] && s_effm[zk * V + i]) zb |= 1ull << i;
  }
  for (int i = 0; i < a.CT; ++i) {
    if (a.t_mask[((size_t)s * K + ck) * V + i] && s_effm[ck * V + i]) cb |= 1ull << i;
  }
  for (int t = tid; t < T; t += blockDim.x) {
    float kr = __int_as_float(0x7f800000);
    for (int r = 0; r < R; ++r) {
      const float al = a.it_alloc[(size_t)t * R + r];
      float h;
      if (creq[r] > 0.f) {
        h = __fdiv_rn(__fsub_rn(al, oh[r]), creq[r]);
      } else {
        h = al >= oh[r] ? BIGF : -1.0f;
      }
      kr = fminf(kr, h);
    }
    a.k_fresh[t] = floorf(kr);
    a.off_fresh[t] = offering_ok(a, t, zb, cb);
  }
}

// ---------------------------------------------------------------------------
// 2. slot-parallel feasibility (one warp per slot, a block row per problem)

__global__ void k_feasible(FfdArgs args, int j) {
  const FfdArgs a = problem(args, blockIdx.y);
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= a.N) return;
  const int K = a.K, V = a.V, T = a.T, R = a.R, Gh = a.Gh;
  const int kind = a.kind[n];
  if (kind == 0) {  // pad slots never take
    if (lane == 0) {
      a.k_eff[n] = 0;
      a.feas[n] = 0;
    }
    return;
  }
  const uint8_t* effm = a.eff;
  const uint8_t* effd = a.eff + K * V;
  const uint8_t* effc = effd + K;
  const uint8_t* effn = effc + K;
  const int* cgt = a.c_gt + (size_t)j * K;
  const int* clt = a.c_lt + (size_t)j * K;

  bool bad = false;
  for (int k = lane; k < K; k += 32) {
    const size_t nk = (size_t)n * K + k;
    bool overlap = false;
    for (int v = 0; v < V; ++v) {
      overlap = overlap || (a.valmask[nk * V + v] && effm[k * V + v]);
    }
    const bool both = a.defines[nk] && effd[k];
    const bool either_conc = !a.complement[nk] || effc[k];
    const bool crossed = imax(a.gt[nk], cgt[k]) >= imin(a.lt[nk], clt[k]);
    const bool empty = either_conc ? !overlap : crossed;
    const bool both_neg = a.negative[nk] && effn[k];
    const bool rule2 = both && empty && !both_neg;
    const bool allow = a.well_known[k] && kind == 2;
    const bool rule1 = effd[k] && !effn[k] && !a.defines[nk] && !allow;
    bad = bad || rule1 || rule2;
  }
  const bool req_ok = !__any_sync(FULL, bad);
  const bool taint_ok =
      kind == 1 ? a.c_exist_taint_ok[(size_t)j * a.N + n] != 0
                : a.c_tmpl_ok[(size_t)j * a.S + imax(a.tmpl[n], 0)] != 0;

  unsigned long long zb, cb;
  joined_zone_ct(a, n, effm, effd, &zb, &cb);
  const float* creq = a.c_requests + (size_t)j * R;
  const float* req = a.requests + (size_t)n * R;
  const uint8_t* cit = a.c_class_it + (size_t)j * T;
  float kmax = -1.0f;
  bool anyv = false;
  for (int t = lane; t < T; t += 32) {
    if (!a.itmask[(size_t)n * T + t] || !cit[t]) continue;
    if (!offering_ok(a, t, zb, cb)) continue;
    anyv = true;
    kmax = fmaxf(kmax, k_raw_at(a, t, req, creq));
  }
  kmax = warp_fmax(kmax);
  anyv = __any_sync(FULL, anyv);

  int cap = INT_MAX;
  for (int g = lane; g < Gh; g += 32) {
    const int c = a.hcount[(size_t)n * Gh + g];
    const bool sel = a.c_h_sel[(size_t)j * Gh + g];
    const int skew = a.h_skew[g];
    const int type = a.h_type[g];
    int cg;
    if (type == 0) {
      cg = sel ? wsub(skew, c) : (c <= skew ? BIGI : 0);
    } else if (type == 1) {
      cg = c == 0 ? (sel ? 1 : BIGI) : 0;
    } else {
      cg = a.hboot[g] ? BIGI : (c > 0 ? BIGI : 0);
    }
    if (!a.c_h_owner[(size_t)j * Gh + g]) cg = BIGI;
    cap = imin(cap, cg);
  }
  cap = imax(warp_min(cap), 0);

  if (lane == 0) {
    float k;
    if (kind == 1) {
      float ke = __int_as_float(0x7f800000);
      for (int r = 0; r < R; ++r) {
        const float h = creq[r] > 0.f
                            ? __fdiv_rn(__fsub_rn(a.capacity[(size_t)n * R + r],
                                                  req[r]),
                                        creq[r])
                            : BIGF;
        ke = fminf(ke, h);
      }
      k = floorf(ke);
    } else {
      k = kmax;
    }
    k = fminf(fmaxf(k, 0.0f), 1073741824.0f);
    const int kmax_i = (int)k;
    const bool feasible = req_ok && taint_ok && (kind == 1 || anyv);
    a.k_eff[n] = feasible ? imin(kmax_i, cap) : 0;
    a.feas[n] = feasible;
  }
}

// ---------------------------------------------------------------------------
// 3. cross-slot decisions (one block per problem)

__global__ void k_decide(FfdArgs args, int j) {
  const FfdArgs a = problem(args, blockIdx.x);
  __shared__ int sh[33];
  const int N = a.N;
  const int tid = threadIdx.x;
  const int chunk = (N + blockDim.x - 1) / blockDim.x;
  const int n0 = imin(tid * chunk, N);
  const int n1 = imin(n0 + chunk, N);

  const int m = a.sc[SC_M];
  const int carry0 = a.sc[SC_CARRY0];
  const int fresh_cap = a.sc[SC_FRESH_CAP];
  const bool single = a.sc[SC_SINGLE] != 0;
  const int nf = *a.next_free;
  const bool overflow0 = *a.overflow != 0;

  // existing slots first-fit in slot order (exclusive prefix)
  int local = 0;
  for (int n = n0; n < n1; ++n) {
    if (a.kind[n] == 1) local = wadd(local, a.k_eff[n]);
  }
  int run = block_excl_scan(local, sh);
  int te_sum = 0;
  for (int n = n0; n < n1; ++n) {
    const int ke = a.kind[n] == 1 ? a.k_eff[n] : 0;
    const int before = run;
    run = wadd(run, ke);
    const int te = imin(imax(wsub(m, before), 0), ke);
    a.take[n] = te;
    te_sum = wadd(te_sum, te);
  }
  const int rem_claims = wsub(m, block_sum(te_sum, sh));

  // in-flight claims emptiest-first: binary-search water-fill
  int hmax = INT_MIN;
  for (int n = n0; n < n1; ++n) {
    const int cap = a.kind[n] == 2 ? a.k_eff[n] : 0;
    hmax = imax(hmax, cap > 0 ? a.podcount[n] : 0);
  }
  int hi = wadd(block_max(hmax, sh), rem_claims);
  int lo = 0;
  for (int it = 0; it < a.level_iters; ++it) {
    const int mid = wadd(wadd(lo, hi), 1) >> 1;
    int s = 0;
    for (int n = n0; n < n1; ++n) {
      const int cap = a.kind[n] == 2 ? a.k_eff[n] : 0;
      if (cap > 0) s = wadd(s, imin(imax(wsub(mid, a.podcount[n]), 0), cap));
    }
    const bool ok = block_sum(s, sh) <= rem_claims;
    lo = ok ? mid : lo;
    hi = ok ? hi : mid - 1;
  }
  const int L = lo;
  int fsum = 0, ecount = 0;
  for (int n = n0; n < n1; ++n) {
    const int cap = a.kind[n] == 2 ? a.k_eff[n] : 0;
    const int f = cap > 0 ? imin(imax(wsub(L, a.podcount[n]), 0), cap) : 0;
    fsum = wadd(fsum, f);
    ecount += (cap > 0 && f < cap && wadd(a.podcount[n], f) == L) ? 1 : 0;
  }
  const int rleft = wsub(rem_claims, block_sum(fsum, sh));
  int erank = block_excl_scan(ecount, sh);
  int first_local = N;
  for (int n = n0; n < n1; ++n) {
    const int cap = a.kind[n] == 2 ? a.k_eff[n] : 0;
    const int f = cap > 0 ? imin(imax(wsub(L, a.podcount[n]), 0), cap) : 0;
    const bool elig = cap > 0 && f < cap && wadd(a.podcount[n], f) == L;
    const int tc = f + ((elig && erank < rleft) ? 1 : 0);
    erank += elig ? 1 : 0;
    a.take[n] = wadd(a.take[n], tc);  // take_exist + take_claims
    if (a.feas[n] && first_local == N) first_local = n;
  }
  const int first = block_min(first_local, sh);

  // single-slot (affinity bootstrap) rule, then the fresh range
  int tsum = 0;
  for (int n = n0; n < n1; ++n) {
    int t = a.take[n];
    if (single) t = n == first ? imin(a.k_eff[n], m) : 0;
    a.take[n] = t;
    tsum = wadd(tsum, t);
  }
  tsum = block_sum(tsum, sh);
  const int rem = wsub(m, tsum);
  const int new_tmpl = a.c_new_template[j];
  const bool has_template = new_tmpl >= 0 && fresh_cap > 0;
  const int kstar = imax(imin(imax(a.c_kstar[j], 1), fresh_cap), 1);
  int n_new = (has_template && rem > 0) ? (rem + kstar - 1) / kstar : 0;
  if (single) n_new = tsum > 0 ? 0 : imin(n_new, 1);
  const long long fresh_end = (long long)nf + n_new;
  int tfsum = 0;
  for (int n = n0; n < n1; ++n) {
    int tf = 0;
    if (n >= nf && (long long)n < fresh_end) {
      tf = imin(imax(wsub(rem, (n - nf) * kstar), 0), kstar);
    }
    a.takes[(size_t)j * N + n] = wadd(a.take[n], tf);
    tfsum = wadd(tfsum, tf);
  }
  tfsum = block_sum(tfsum, sh);
  if (tid == 0) {
    const int unplaced_step = wsub(rem, tfsum);
    const int placed = wsub(m, unplaced_step);
    const int carry_after = wsub(carry0, placed);
    const bool is_wf = a.c_wf_group[j] >= 0;
    a.unplaced[j] = is_wf ? (a.c_sub_last[j] ? carry_after : 0) : unplaced_step;
    *a.carry = carry_after;
    *a.next_free = wadd(nf, n_new);
    *a.overflow = (overflow0 || fresh_end > (long long)N) ? 1 : 0;
    a.sc[SC_NF_OLD] = nf;
    a.sc[SC_NNEW] = n_new;
  }
}

// ---------------------------------------------------------------------------
// 4. slot-parallel merge (one warp per slot, a block row per problem)

__global__ void k_merge(FfdArgs args, int j) {
  const FfdArgs a = problem(args, blockIdx.y);
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= a.N) return;
  const int K = a.K, V = a.V, T = a.T, R = a.R;
  const int nf = a.sc[SC_NF_OLD];
  const int nn = a.sc[SC_NNEW];
  const int s = a.sc[SC_S];
  const bool fresh = n >= nf && (long long)n < (long long)nf + nn;
  const int tk = a.takes[(size_t)j * a.N + n];
  const bool joined = a.take[n] > 0 || fresh;
  const float tkf = (float)tk;
  const float* creq = a.c_requests + (size_t)j * R;
  float* req = a.requests + (size_t)n * R;

  if (!joined) {
    // requests = requests + 0 * r on every slot, as in the plain version
    for (int r = lane; r < R; r += 32) req[r] = __fadd_rn(req[r], __fmul_rn(tkf, creq[r]));
    return;
  }
  const uint8_t* effm = a.eff;
  const uint8_t* effd = a.eff + K * V;
  const uint8_t* effc = effd + K;
  const uint8_t* effn = effc + K;
  const uint8_t* cit = a.c_class_it + (size_t)j * T;
  uint8_t* itm = a.itmask + (size_t)n * T;

  // itmask, from the pre-merge planes and requests
  if (fresh) {
    const uint8_t* tit = a.t_it + (size_t)s * T;
    for (int t = lane; t < T; t += 32) {
      itm[t] = tit[t] && cit[t] && a.k_fresh[t] >= tkf && a.off_fresh[t];
    }
  } else {
    unsigned long long zb, cb;
    joined_zone_ct(a, n, effm, effd, &zb, &cb);
    for (int t = lane; t < T; t += 32) {
      if (!itm[t]) continue;
      itm[t] = cit[t] && k_raw_at(a, t, req, creq) >= tkf &&
               offering_ok(a, t, zb, cb);
    }
  }
  __syncwarp();

  // requirement planes: intersect-on-add over the keys the class defines
  for (int e = lane; e < K * V; e += 32) {
    const int k = e / V, v = e % V;
    const size_t idx = ((size_t)n * K + k) * V + v;
    const bool base = fresh ? a.t_mask[((size_t)s * K + k) * V + v] != 0
                            : a.valmask[idx] != 0;
    a.valmask[idx] = effd[k] ? (base && effm[e]) : base;
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
  for (int r = lane; r < R; r += 32) {
    const float base = fresh ? a.t_overhead[(size_t)s * R + r] : req[r];
    req[r] = __fadd_rn(base, __fmul_rn(tkf, creq[r]));
    if (fresh) a.capacity[(size_t)n * R + r] = BIGF;
  }
  for (int g = lane; g < a.Gh; g += 32) {
    if (a.c_h_sel[(size_t)j * a.Gh + g]) {
      a.hcount[(size_t)n * a.Gh + g] = wadd(a.hcount[(size_t)n * a.Gh + g], tk);
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
      const uint8_t* row = a.valmask + nk * V;
      int rc = 0;
      for (int v = 0; v < V; ++v) rc += row[v] ? 1 : 0;
      if (a.z_type[g] != 1 && rc != 1) continue;
      for (int v = 0; v < V; ++v) {
        if (row[v]) atomicAdd(a.zcount + (size_t)g * V + v, tk);
      }
    }
  }
}

// the slot-parallel kernels' grid: warp blocks over slots x problems
dim3 warp_grid(const FfdArgs& a) {
  return dim3((a.N + (WARP_BLOCK / 32) - 1) / (WARP_BLOCK / 32), a.B);
}

}  // namespace

extern "C" {

int ffd_args_size() { return (int)sizeof(FfdArgs); }

int ffd_prologue_smem(int K, int V, int Gh, int Gz) {
  return (Gh + 4 * V) * (int)sizeof(int) + Gz * V + K * V + 3 * K;
}

// One entry per kernel; class step j runs the four in this order on
// `stream`, with no host synchronisation, for all B problems of `args`.
// Each launches its kernel once and returns cudaGetLastError() (0 on
// success).
int launch_k_prologue(const FfdArgs* args, int j, cudaStream_t stream) {
  const FfdArgs a = *args;
  const int smem = ffd_prologue_smem(a.K, a.V, a.Gh, a.Gz);
  k_prologue<<<a.B, 256, smem, stream>>>(a, j);
  return (int)cudaGetLastError();
}

int launch_k_feasible(const FfdArgs* args, int j, cudaStream_t stream) {
  const FfdArgs a = *args;
  k_feasible<<<warp_grid(a), WARP_BLOCK, 0, stream>>>(a, j);
  return (int)cudaGetLastError();
}

int launch_k_decide(const FfdArgs* args, int j, cudaStream_t stream) {
  const FfdArgs a = *args;
  k_decide<<<a.B, DECIDE_THREADS, 0, stream>>>(a, j);
  return (int)cudaGetLastError();
}

int launch_k_merge(const FfdArgs* args, int j, cudaStream_t stream) {
  const FfdArgs a = *args;
  k_merge<<<warp_grid(a), WARP_BLOCK, 0, stream>>>(a, j);
  return (int)cudaGetLastError();
}

const char* ffd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
