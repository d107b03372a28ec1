// Double-single panel factor for the DD blocked Cholesky (K8): one [B, B]
// panel P = (Ph, Pl) in, its lower factor L = (Lh, Ll) and the factor's
// inverse W = L^-1 = (Wh, Wl) out, bit for bit what the plain version
// (ops/ddchol.py: panel_factor_ref) computes.
//
// It replaces no Pallas kernel: in the JAX package the panel factor
// (hdsdp_tpu/ops/ddchol.py:44-89, `_panel_factor`) is a lax.fori_loop that
// XLA compiles into one device program.  Transcribed into eager PyTorch
// (panel_factor_ref) each of the B steps is ~200 elementwise launches; this
// kernel is the whole factor in one launch.
//
// What the plain version computes, for j = 0 .. B-1 (a right-looking sweep
// with the inverse's row j built in the same step):
//   (s, is_j) = dd.sqrt(P[j, j]), dd.inv(s)   (NaN for a pivot <= 0: the
//               PSD predicate, which then spreads through everything after)
//   c_i       = dd.mul(P[i, j], is_j) for i >= j, (+0, +0) for i < j
//   L[:, j]   = c
//   P[i, k]   = dd.sub(P[i, k], dd.mul(c_i, c_k))      for every i, k
//   W[j, k]   = dd.mul(dd.sub((k == j, 0), v_jk), is_j), v_jk = dd.dd_sum
//               over i of dd.mul(L[j, i] if i < j else +0, W[i, k]) (the JAX
//               tree: element i with element i + B/2, then halve again).
//
// This kernel computes the same numbers in another order, in two phases:
//   phase L: the pivots in turn, each rank-1 update applied only to the
//            trailing block's strictly lower triangle and to the diagonal
//            (the rest of the panel is scratch that no output reads), each
//            entry still taking its updates in ascending j;
//   phase W: W = L^-1 by independent columns, column k being the forward
//            substitution L w = e_k: W[j, k] for j >= k from the final L
//            row j and the entries W[i, k], k <= i < j, through the same
//            tree, with the leaves i < k and i >= j taken as the constant
//            (+0, +0) that the plain version's products give there; the
//            upper entries W[j, k], k > j, are dd.mul(dd.sub(0, 0), is_j).
// Why that is bit-exact: an entry's value depends only on the operations
// applied to it and their order, which phase L keeps; a leaf outside
// [k, j) is dd.mul of a finite L[j, i] (or the masked +0) with an upper or
// not yet written W entry, (+0, +0), which is exactly (+0, +0) -- unless
// row j of L holds a NaN, and then P[j, j] took a NaN update, is_j is NaN
// and every W[j, k] is (NaN, NaN) in both orders (L never holds an inf:
// an overflowing DD product is NaN).  A tree node of two such constants is
// (+0, +0) again, so a subtree with no leaf in [k, j) is skipped; a node
// with one child in [k, j) is evaluated in full (dd_sum's node is not the
// identity on every operand: signed zeros, unnormalised pairs).  The CPU
// test tests/test_torch_ddchol.py::test_k8_schedule_mirror_is_bitwise runs
// a plain-torch mirror of this order against panel_factor_ref bit for bit
// at B = 32, 64, 128 and 256 on the four panel kinds chip_smoke.py uses
// (well-conditioned, cond 1e12, indefinite, entries 1e-28..1e28).
//
// Every DD operation is spelled with __fadd_rn/__fsub_rn/__fmul_rn/
// __fdiv_rn/__fsqrt_rn: they are never contracted into FMAs (Dekker's
// two_prod is wrong under contraction) nor reassociated, and there is no
// --use_fast_math (no flush of denormals).  No pointer is __restrict__:
// nothing written in a launch is read through the read-only path.
//
// Design: one thread-block cluster per panel (each instance of a fleet its
// own cluster), of CS = B / R CTAs, R rows of the panel a CTA: R = 32, CS =
// 8 (the portable cluster size) at B = 256; R = 16, CS = 8, 4, 2 at B =
// 128, 64, 32.  A CTA has a scale warp, a pivot warp and R / 2 worker
// warps (18 warps, 576 threads at B = 256).
//   Shared memory: the rows i = rank + CS r (r = 0 .. R-1, dealt cyclically
//   so that the shrinking trailing block stays balanced) hold their
//   strictly lower entries, P first and column j becoming L[:, j] in place
//   at step j; every CTA also holds the whole diagonal and subdiagonal,
//   updated alike in every CTA (so each computes every pivot itself, the
//   same bits), the pivots, and three buffers of the broadcast column, each
//   with an mbarrier.  Static, per CTA: 47,904 bytes at B = 256, 3,872 at
//   B = 32; W lives in registers.
//   Phase L, step j: the pivot warp has taken pivot j while column j - 1
//   travelled, from P[j, j] and P[j, j - 1] as step j - 2 left them (it
//   applies step j - 1 to them itself); the scale warp (lane r, row rank + CS
//   r) scales its rows of column j and sends c to every CTA with st.async,
//   which the receiving CTA's mbarrier counts; the workers wait for the
//   column, apply step j to the diagonal, the subdiagonal and column j + 2 of
//   their rows, raise a counter (what the pivot warp and the scale warp wait
//   on), and then apply the rest of step j (columns j + 3 ..) while the next
//   pivot is taken; the scale warp applies step j to column j + 1.  An entry
//   (i, k) is always updated by the same thread (the worker of row i, lane k
//   mod 32; the scale warp for column j + 1), so its updates stay in order.  A
//   cluster barrier a step keeps a CTA from writing a column buffer that
//   another CTA still reads (three buffers) and orders the pivot warp's reads
//   of the diagonal and subdiagonal before the workers' next update of them
//   (the pivot warp's arrive is a release, the others relaxed); the last one
//   releases the rows of L to phase W.
//   Phase W: worker g of the cluster (g = (R / 2) rank + worker) takes columns
//   g and B - 1 - g (257 column-steps a worker at B = 256), holding W[:, k] in
//   registers, leaf i in lane i mod 32, slot i / 32.  The tree's strides B/2
//   .. 32 are in-lane over the slots, 16 .. 1 are __shfl_down_sync (the two
//   columns share them once both run); L's row j is read from its owner's
//   shared memory, and the new W[j, k] goes to lane j mod 32 by a shuffle.
//
// What bounds it: issue slots and dependent chains on the 8 SMs of the
// cluster, not memory.  Phase L's early steps are bound by the trailing update
// (~35 f32 operations an entry of the trailing lower triangle, over half of
// them in the first 64 steps), its late steps by the chain of pivots (dd.sqrt,
// dd.inv and two DD products a step, ~100 dependent operations) and the
// column's trip to every CTA.  Phase W is ~600 instructions a column-step (the
// present slots' leaf products, 7 in-lane and 5 shuffle tree levels, the pivot
// product), 257 column-steps a worker, 4 workers to an SM sub-partition.  The
// f32 operations that L and W need, 35 B^3 / 3 = 2.0e8 at B = 256, take ~0.006
// ms at the card's FMA-free rate over all 132 SMs; the cluster has 8 of them.
//
// Interface (plain C, loaded with ctypes): ph, pl are [n_inst, B, B]
// contiguous f32, read only (their lower triangle); lh, ll, wh, wl are
// [n_inst, B, B] contiguous f32 outputs (fully written); B is 32, 64, 128
// or 256; the launch goes on the caller's stream, nothing is allocated,
// and the return value is a cudaError (a cluster the card will not
// schedule is refused there).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// The shape for a panel of B = 2^LOGB: R rows of the panel a CTA, CS = B /
// R CTAs in the cluster (at most 8, the portable cluster size), R / 2
// worker warps a CTA beside its scale and pivot warps.
template <int LOGB>
struct Shape {
  static constexpr int B = 1 << LOGB;
  static constexpr int R = B >= 256 ? 32 : 16;
  static constexpr int CS = B / R;
  static constexpr int kWorkers = R / 2;
  static constexpr int kThreads = 32 * (kWorkers + 2);
  static_assert(CS >= 2 && CS <= 8 && B / 2 == CS * kWorkers, "B must be 32, 64, 128 or 256");
};

struct DD {
  float h, l;
};

__device__ __forceinline__ DD two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

__device__ __forceinline__ DD quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ DD split(float a) {
  const float t = __fmul_rn(4097.0f, a);
  const float hi = __fsub_rn(t, __fsub_rn(t, a));
  return {hi, __fsub_rn(a, hi)};
}

__device__ __forceinline__ DD two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  const DD as = split(a), bs = split(b);
  // ((ah*bh - p) + ah*bl + al*bh) + al*bl
  float e = __fsub_rn(__fmul_rn(as.h, bs.h), p);
  e = __fadd_rn(e, __fmul_rn(as.h, bs.l));
  e = __fadd_rn(e, __fmul_rn(as.l, bs.h));
  e = __fadd_rn(e, __fmul_rn(as.l, bs.l));
  return {p, e};
}

__device__ __forceinline__ DD dd_add(DD x, DD y) {
  const DD s = two_sum(x.h, y.h);
  return quick_two_sum(s.h, __fadd_rn(s.l, __fadd_rn(x.l, y.l)));
}

__device__ __forceinline__ DD dd_sub(DD x, DD y) { return dd_add(x, {-y.h, -y.l}); }

__device__ __forceinline__ DD dd_mul(DD x, DD y) {
  const DD p = two_prod(x.h, y.h);
  const float c = __fadd_rn(__fmul_rn(x.h, y.l), __fmul_rn(x.l, y.h));
  return quick_two_sum(p.h, __fadd_rn(p.l, c));
}

__device__ __forceinline__ DD dd_div(DD x, DD y) {
  const float q1 = __fdiv_rn(x.h, y.h);
  const DD p = dd_mul({q1, 0.0f}, y);
  const DD r = dd_add(x, {-p.h, -p.l});
  const float q2 = __fdiv_rn(__fadd_rn(r.h, r.l), y.h);
  return quick_two_sum(q1, q2);
}

__device__ __forceinline__ DD dd_sqrt(DD x) {
  const float s = __fsqrt_rn(x.h);
  const DD p = two_prod(s, s);
  const DD r = dd_add(x, {-p.h, -p.l});
  return quick_two_sum(s, __fdiv_rn(__fadd_rn(r.h, r.l), __fmul_rn(2.0f, s)));
}

// one node of dd_sum's tree: (a + b) with a the lower-index operand
__device__ __forceinline__ DD tree_node(DD a, DD b) {
  const DD s = two_sum(a.h, b.h);
  return quick_two_sum(s.h, __fadd_rn(__fadd_rn(s.l, a.l), b.l));
}

// The split cluster barrier.  Phase L's barriers are relaxed where the
// warp's reads of what the next step overwrites feed arithmetic that issues
// before the arrive (the scale warp and the workers): they only keep a CTA
// from overwriting a column buffer that another CTA still reads; the
// columns themselves travel by st.async and mbarrier.  The pivot warp's
// arrive is a release: it takes pivot j + 1 after the arrive of phase j,
// from dg[j + 1] and e[j] read before it, which step j then updates.  The
// last one releases the rows of L that phase W reads from other CTAs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the same shared memory address in the CTA of rank q
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(q));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// this CTA's arrival on a phase that also waits for `bytes` of st.async
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// (h, l) into another CTA's shared memory, counted there on its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, DD x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(x.h), "f"(x.l), "r"(bar)
      : "memory");
}

// offset of a CTA's r-th row (panel row q + CS r, strictly lower entries
// only) in the row storage of the CTA of rank q
template <int CS>
__device__ __forceinline__ int row_off(int q, int r) {
  return r * q + CS * r * (r - 1) / 2;
}

// One step's update of P[i, i] and of P[i + 1, i] (the column c of L that
// the step broadcast).
__device__ __forceinline__ void diag_step(float* dgh, float* dgl, const float2* c, int i) {
  const DD ci = {c[i].x, c[i].y};
  const DD p = dd_sub({dgh[i], dgl[i]}, dd_mul(ci, ci));
  dgh[i] = p.h;
  dgl[i] = p.l;
}

__device__ __forceinline__ void subdiag_step(float* eh, float* el, const float2* c, int i) {
  const DD p = dd_sub({eh[i], el[i]}, dd_mul({c[i + 1].x, c[i + 1].y}, {c[i].x, c[i].y}));
  eh[i] = p.h;
  el[i] = p.l;
}

// Step jj's update, P[i, k] -= c_i c_k, applied to this CTA's rows i for
// the columns k in [k_from, min(k_to, i)).  Row r is always updated by
// worker r or R - 1 - r, entry k by lane k mod 32.
template <int CS, int R>
__device__ __forceinline__ void update_rows(int warp, int lane, int rank, int k_from, int k_to,
                                            const float2* c, float* sth, float* stl) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = t == 0 ? warp : R - 1 - warp;
    const int i = rank + CS * r;
    const int end = min(i, k_to);
    if (k_from >= end) continue;
    const DD ci = {c[i].x, c[i].y};
    const int o = row_off<CS>(rank, r);
    int k = (k_from & ~31) + lane;
    if (k < k_from) k += 32;
#pragma unroll 4
    for (; k < end; k += 32) {
      const DD p = dd_sub({sth[o + k], stl[o + k]}, dd_mul(ci, {c[k].x, c[k].y}));
      sth[o + k] = p.h;
      stl[o + k] = p.l;
    }
  }
}

// The leaves of dd_sum's tree for column k at step j, leaf i = lane + 32 m
// in slot m: L[j, i] W[i, k] for i in [k, j), else (+0, +0); then the
// tree's strides B/2 .. 32, in registers.  v[0] is left with this lane's
// partial sum; the mask of slots holding a leaf in [k, j) is the same in
// every lane, and a node whose two subtrees hold none is skipped (it
// would give (+0, +0)).  Every loop has a constant trip count, so v stays
// in registers.
template <int LNS, int NS = 1 << LNS>
__device__ __forceinline__ DD lane_sum(const DD (&row)[NS], const DD (&w)[NS], int k, int j,
                                       int lane) {
  DD v[NS];
  unsigned pres = 0;
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    v[m] = {0.0f, 0.0f};
    if (max(k, 32 * m) < min(j, 32 * m + 32)) {
      pres |= 1u << m;
      const int i = lane + 32 * m;
      if (i >= k && i < j) v[m] = dd_mul(row[m], w[m]);
    }
  }
#pragma unroll
  for (int lv = LNS - 1; lv >= 0; --lv) {
    const int h = 1 << lv;
    unsigned np = 0;
#pragma unroll
    for (int m = 0; m < NS / 2; ++m) {
      if (m < h && (pres & ((1u << m) | (1u << (m + h))))) {
        v[m] = tree_node(v[m], v[m + h]);
        np |= 1u << m;
      }
    }
    pres = np;
  }
  return v[0];
}

// The tree's strides 16 .. 1: lane l with lane l + s; the root, in every
// lane.
__device__ __forceinline__ DD lane_root(DD x) {
#pragma unroll
  for (int lv = 4; lv >= 0; --lv) {
    const int s = 1 << lv;
    const DD y = {__shfl_down_sync(0xffffffffu, x.h, s), __shfl_down_sync(0xffffffffu, x.l, s)};
    x = tree_node(x, y);
  }
  return {__shfl_sync(0xffffffffu, x.h, 0), __shfl_sync(0xffffffffu, x.l, 0)};
}

// The tree's strides 16 .. 1 for two columns at once: a (column A) and b
// (column B) are this lane's partial sums.  Stride 16 takes A's pairs in
// lanes 0-15 and B's in lanes 16-31 (one exchange across the halves), the
// strides 8 .. 1 then run in both halves together.  Returns A's root
// (ra) and B's root (rb), each in every lane.
__device__ __forceinline__ void pair_roots(DD a, DD b, int lane, DD& ra, DD& rb) {
  const bool lo = lane < 16;
  const DD send = lo ? b : a;
  const DD recv = {__shfl_xor_sync(0xffffffffu, send.h, 16),
                   __shfl_xor_sync(0xffffffffu, send.l, 16)};
  DD x = lo ? tree_node(a, recv) : tree_node(recv, b);
#pragma unroll
  for (int lv = 3; lv >= 0; --lv) {
    const int s = 1 << lv;
    const DD y = {__shfl_down_sync(0xffffffffu, x.h, s), __shfl_down_sync(0xffffffffu, x.l, s)};
    x = tree_node(x, y);
  }
  ra = {__shfl_sync(0xffffffffu, x.h, 0), __shfl_sync(0xffffffffu, x.l, 0)};
  rb = {__shfl_sync(0xffffffffu, x.h, 16), __shfl_sync(0xffffffffu, x.l, 16)};
}

// w[j / 32] = x in lane j % 32 (a bit test, not an index compare: the
// compiler turns `m == j / 32` into an indexed store, which moves w to the
// stack)
template <int NS>
__device__ __forceinline__ void set_slot(DD (&w)[NS], int j, int lane, DD x) {
  const unsigned sel = lane == (j & 31) ? 1u << (j >> 5) : 0u;
#pragma unroll
  for (int m = 0; m < NS; ++m)
    if (sel & (1u << m)) w[m] = x;
}

// Counters in shared memory that one warp of the CTA raises (a release)
// and another waits on (an acquire): what the raiser wrote before is then
// visible to the waiter.  The waiter naps between polls, so that it leaves
// the issue slots to the workers of its SM sub-partition.
__device__ __forceinline__ void spin_until(const int* flag, int target) {
  const uint32_t a = smem_addr(flag);
  int v;
  while (true) {
    asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
    if (v >= target) break;
    __nanosleep(20);
  }
}

__device__ __forceinline__ void raise_to(int* flag, int v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(smem_addr(flag)), "r"(v)
               : "memory");
}

__device__ __forceinline__ void raise_by_one(int* flag) {
  asm volatile("red.release.cta.shared::cta.add.u32 [%0], 1;\n" ::"r"(smem_addr(flag))
               : "memory");
}

// pivot j (P[j, j] as it is taken, and is_j), then the count of pivots
// published
__device__ __forceinline__ void publish_pivot(float* pdh, float* pdl, float* ish, float* isl,
                                              int* pdone, int j, DD d, DD is) {
  pdh[j] = d.h;
  pdl[j] = d.l;
  ish[j] = is.h;
  isl[j] = is.l;
  raise_to(pdone, j + 1);
}

// row j of L, the entries i = lane + 32 m in [k, j), from the shared memory
// of the CTA that owns the row
template <int CS, int NS>
__device__ __forceinline__ void load_row(cg::cluster_group& cluster, float* sth, float* stl,
                                         DD (&row)[NS], int j, int k, int lane) {
  const int q = j % CS, o = row_off<CS>(q, j / CS);
  const float* rh = cluster.map_shared_rank(sth, q) + o;
  const float* rl = cluster.map_shared_rank(stl, q) + o;
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int i = lane + 32 * m;
    if (i >= k && i < j) row[m] = {rh[i], rl[i]};
  }
}

template <int LOGB>
__global__ void __launch_bounds__(Shape<LOGB>::kThreads, 1)
dd_panel_kernel(const float* ph, const float* pl, float* lh, float* ll, float* wh, float* wl) {
  using S = Shape<LOGB>;
  constexpr int B = S::B, R = S::R, CS = S::CS, kWorkers = S::kWorkers, kThreads = S::kThreads;
  constexpr int NS = B / 32;  // phase W: leaf slots per lane
  constexpr int kStore = R * (CS - 1) + CS * R * (R - 1) / 2;

  __shared__ float st_h[kStore], st_l[kStore];  // this CTA's rows, strictly lower: P, then L
  __shared__ float2 c2[3][B];                   // the broadcast column of steps j mod 3
  __shared__ uint64_t full[3];                  // ... and its arrival, one mbarrier each
  __shared__ float dg_h[B], dg_l[B];            // the diagonal: P[i, i], then L[i, i]
  __shared__ float e_h[B], e_l[B];              // the subdiagonal P[i + 1, i]
  __shared__ float pd_h[B], pd_l[B];            // P[j, j] as pivot j takes it
  __shared__ float is_h[B], is_l[B];            // the inverse pivots
  __shared__ int wdone, pdone;                  // worker warps' steps done, pivots published

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t base = (size_t)(blockIdx.x / CS) * B * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp - 2;  // worker index; -2 the scale warp, -1 the pivot warp

  // -- load: this CTA's rows (strictly lower), the whole diagonal and
  // subdiagonal ------------------------------------------------------------
  if (wk >= 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = t == 0 ? wk : R - 1 - wk;
      const int i = rank + CS * r, o = row_off<CS>(rank, r);
      for (int k = lane; k < i; k += 32) {
        st_h[o + k] = ph[base + (size_t)i * B + k];
        st_l[o + k] = pl[base + (size_t)i * B + k];
      }
    }
  }
  for (int i = tid; i < B; i += kThreads) {
    dg_h[i] = ph[base + (size_t)i * B + i];
    dg_l[i] = pl[base + (size_t)i * B + i];
    if (i + 1 < B) {
      e_h[i] = ph[base + (size_t)(i + 1) * B + i];
      e_l[i] = pl[base + (size_t)(i + 1) * B + i];
    }
  }
  if (tid == 0) {
    wdone = pdone = 0;
    for (int b = 0; b < 3; ++b) mbar_init(smem_addr(&full[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // steps 0, 1, 2: the rows j .. B - 1, 8 bytes each, from every CTA
    for (int b = 0; b < 3; ++b) mbar_expect(smem_addr(&full[b]), 8 * (B - b));
  }
  cluster.sync();  // every CTA of the cluster has started, loaded and armed

  // -- phase L: cluster barrier phases 0 .. B ------------------------------
  if (warp == 1) {
    // the pivot warp: pivot j + 1 from the diagonal and subdiagonal entries
    // of row j + 1 as step j - 1 leaves them, one step ahead of the scale
    // warp
    DD d = {dg_h[0], dg_l[0]};
    DD is = dd_div({1.0f, 0.0f}, dd_sqrt(d));
    if (lane == 0) publish_pivot(pd_h, pd_l, is_h, is_l, &pdone, 0, d, is);
    for (int j = 0; j < B; ++j) {
      DD e = {0.0f, 0.0f};
      if (j + 1 < B) {
        spin_until(&wdone, kWorkers * j);  // the workers' step j - 1
        e = {e_h[j], e_l[j]};
        d = {dg_h[j + 1], dg_l[j + 1]};
      }
      // phase j; a release, since the arithmetic on these reads comes after
      // it and step j then writes dg[j + 1] and e[j]
      cluster_arrive_release();
      if (j + 1 < B) {
        const DD c = dd_mul(e, is);  // L[j + 1, j]
        d = dd_sub(d, dd_mul(c, c));
        is = dd_div({1.0f, 0.0f}, dd_sqrt(d));
        if (lane == 0) publish_pivot(pd_h, pd_l, is_h, is_l, &pdone, j + 1, d, is);
      }
      cluster_wait();
    }
    cluster_arrive_release();  // phase B
  } else if (warp == 0) {
    // the scale warp: lane r scales row rank + CS r of column j and sends
    // it to every CTA, then applies step j to its entry of column j + 1
    const int i = rank + CS * lane, o = row_off<CS>(rank, lane);
    for (int j = 0; j < B; ++j) {
      const int b = j % 3;
      spin_until(&pdone, j + 1);
      if (lane < R && i >= j) {
        const DD is = {is_h[j], is_l[j]};
        const DD c = dd_mul(i == j ? DD{pd_h[j], pd_l[j]} : DD{st_h[o + j], st_l[o + j]}, is);
        if (i > j) {
          st_h[o + j] = c.h;
          st_l[o + j] = c.l;
        }
        const uint32_t at = smem_addr(&c2[b][i]), bar = smem_addr(&full[b]);
        for (int q = 0; q < CS; ++q) st_async(cluster_addr(at, q), c, cluster_addr(bar, q));
      }
      cluster_arrive_relaxed();  // phase j
      mbar_wait(smem_addr(&full[b]), (j / 3) & 1);  // column j from every CTA
      if (lane == 0 && j + 3 < B) mbar_expect(smem_addr(&full[b]), 8 * (B - j - 3));
      if (j + 2 < B) {
        spin_until(&wdone, kWorkers * j);  // the workers' step j - 1 on column j + 1
        if (lane < R && i > j + 1) {
          const DD p = dd_sub({st_h[o + j + 1], st_l[o + j + 1]},
                              dd_mul({c2[b][i].x, c2[b][i].y}, {c2[b][j + 1].x, c2[b][j + 1].y}));
          st_h[o + j + 1] = p.h;
          st_l[o + j + 1] = p.l;
        }
      }
      cluster_wait();  // every CTA is done with the buffer step j + 1 writes
    }
    cluster_arrive_release();  // phase B
  } else {
    cluster_arrive_relaxed();  // phase 0
    for (int j = 0; j < B; ++j) {
      const int b = j % 3;
      const float2* c = c2[b];
      cluster_wait();                               // phase j
      mbar_wait(smem_addr(&full[b]), (j / 3) & 1);  // column j of L from every CTA
      // step j on the diagonal and subdiagonal (what the pivots read) and on
      // column j + 2 of this CTA's rows
      const int i = tid - 64;  // this thread's entry of the diagonal and subdiagonal
      if (i == j) {
        dg_h[i] = c[i].x;
        dg_l[i] = c[i].y;
      } else if (i > j && i < B) {
        diag_step(dg_h, dg_l, c, i);
        if (i + 1 < B) subdiag_step(e_h, e_l, c, i);
      }
      update_rows<CS, R>(wk, lane, rank, j + 2, j + 3, c, st_h, st_l);
      __syncwarp();
      if (lane == 0) raise_by_one(&wdone);
      if (j + 1 < B) {
        cluster_arrive_relaxed();  // phase j + 1
      } else {
        cluster_arrive_release();  // phase B
      }
      // the rest of step j: columns j + 3 ..
      update_rows<CS, R>(wk, lane, rank, j + 3, B, c, st_h, st_l);
    }
  }
  cluster_wait();  // phase B: every row of L final in every CTA

  if (wk >= 0) {
    // -- L out, and W's upper triangle: W[i, k] = dd.mul(dd.sub(0, 0),
    // is_i) for k > i (the plain version's value there: (+0, +0), or NaN)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = t == 0 ? wk : R - 1 - wk;
      const int i = rank + CS * r, o = row_off<CS>(rank, r);
      const DD u = dd_mul(dd_sub({0.0f, 0.0f}, {0.0f, 0.0f}), {is_h[i], is_l[i]});
      const size_t row = base + (size_t)i * B;
      for (int k = lane; k < B; k += 32) {
        lh[row + k] = k < i ? st_h[o + k] : (k == i ? dg_h[i] : 0.0f);
        ll[row + k] = k < i ? st_l[o + k] : (k == i ? dg_l[i] : 0.0f);
        if (k > i) {
          wh[row + k] = u.h;
          wl[row + k] = u.l;
        }
      }
    }

    // -- phase W: columns k1 = g and k2 = B - 1 - g of this worker (g =
    // (R / 2) rank + wk), B - g steps, the last g + 1 of them for both
    // columns, which then share the shuffle levels
    const int g = kWorkers * rank + wk;
    const int k1 = g, k2 = B - 1 - g;
    DD w1[NS], w2[NS], row[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) w1[m] = w2[m] = row[m] = {0.0f, 0.0f};
    for (int j = k1; j < B; ++j) {
      load_row<CS, NS>(cluster, st_h, st_l, row, j, k1, lane);
      const DD isj = {is_h[j], is_l[j]};
      const size_t at = base + (size_t)j * B;
      DD r1, r2;
      if (j < k2) {
        r1 = lane_root(lane_sum<LOGB - 5>(row, w1, k1, j, lane));
      } else {
        pair_roots(lane_sum<LOGB - 5>(row, w1, k1, j, lane),
                   lane_sum<LOGB - 5>(row, w2, k2, j, lane), lane, r1, r2);
        const DD x = dd_mul(dd_sub({j == k2 ? 1.0f : 0.0f, 0.0f}, r2), isj);
        set_slot<NS>(w2, j, lane, x);
        if (lane == 0) {
          wh[at + k2] = x.h;
          wl[at + k2] = x.l;
        }
      }
      const DD x = dd_mul(dd_sub({j == k1 ? 1.0f : 0.0f, 0.0f}, r1), isj);
      set_slot<NS>(w1, j, lane, x);
      if (lane == 0) {
        wh[at + k1] = x.h;
        wl[at + k1] = x.l;
      }
    }
  }
  cluster.sync();  // no CTA leaves while another reads its rows
}

template <int LOGB>
cudaError_t launch(const float* ph, const float* pl, float* lh, float* ll, float* wh, float* wl,
                   int n_inst, cudaStream_t stream) {
  constexpr int CS = Shape<LOGB>::CS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_inst * CS), 1, 1);
  cfg.blockDim = dim3(Shape<LOGB>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dd_panel_kernel<LOGB>, ph, pl, lh, ll, wh, wl);
}

}  // namespace

extern "C" int dd_panel_launch(void* ph, void* pl, void* lh, void* ll, void* wh, void* wl,
                               int B, int n_inst, void* stream) {
  if (n_inst < 0) return (int)cudaErrorInvalidValue;
  if (n_inst == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)ph, *b = (const float*)pl;
  float *c = (float*)lh, *d = (float*)ll, *e = (float*)wh, *f = (float*)wl;
  cudaError_t err;
  switch (B) {
    case 32: err = launch<5>(a, b, c, d, e, f, n_inst, s); break;
    case 64: err = launch<6>(a, b, c, d, e, f, n_inst, s); break;
    case 128: err = launch<7>(a, b, c, d, e, f, n_inst, s); break;
    case 256: err = launch<8>(a, b, c, d, e, f, n_inst, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // clear it: the next torch launch must not report it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
