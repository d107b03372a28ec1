// Double-single panel factor for the DD blocked Cholesky (K8): one [B, B]
// panel P = (Ph, Pl) in, its lower factor L = (Lh, Ll) and the factor's
// inverse W = L^-1 = (Wh, Wl) out, in one right-looking sweep.
//
// It replaces no Pallas kernel: in the JAX package the panel factor
// (hdsdp_tpu/ops/ddchol.py:44-89, `_panel_factor`) is a lax.fori_loop that
// XLA compiles into one device program (its call site, ddchol.py:84-88, is
// inside another fori_loop over the panels).  Transcribed into eager
// PyTorch (ops/ddchol.py: panel_factor_ref, the plain version) each of the
// B steps is ~150-250 elementwise launches; this kernel is the whole sweep
// in one launch.
//
// What it computes, for j = 0 .. B-1, exactly as panel_factor_ref does:
//   (s, is)   = dd.sqrt(P[j, j]), dd.inv(s)   (NaN for a pivot <= 0: the
//               PSD predicate, which then spreads through everything)
//   c_i       = dd.mul(P[i, j], is) for i >= j, (+0, +0) for i < j
//   L[:, j]   = c
//   P[i, k]   = dd.sub(P[i, k], dd.mul(c_i, c_k))        for every i, k
//   t_ik      = dd.mul(r_i, W[i, k]), r_i = L[j, i] for i < j, else (+0, +0)
//   v_k       = dd.dd_sum over i of t_ik (the JAX tree: element i with
//               element i + B/2, then halve again)
//   W[j, k]   = dd.mul(dd.sub((k == j, 0), v_k), is)
// Every DD operation is spelled with __fadd_rn/__fsub_rn/__fmul_rn/
// __fdiv_rn/__fsqrt_rn: they are never contracted into FMAs (Dekker's
// two_prod is wrong under contraction) nor reassociated, and there is no
// --use_fast_math (no flush of denormals), so the outputs are bit-identical
// to the plain version's, signed zeros included.  The masked-out region
// (rows and columns < j) is updated too, as in the plain version: skipping
// it would not change L or W, but computing it keeps the two sweeps the
// same operation for operation.
//
// The dd_sum tree.  With B = 2^b and the tree pairing element i with
// i + B/2 first, the sum over the residue class i = r (mod G) (G = 2^g) is
// a subtree of the same shape; each of G threads per column k walks one
// such class sequentially, taking its leaves in bit-reversed order (which
// turns the stride-halving tree into the contiguous pairwise one, evaluated
// with a compile-time recursion in registers), and the G partial sums are
// then combined by the tree's top g levels in shared memory.
//
// Design: one thread block of 1024 threads per panel (per instance of a
// fleet, blockIdx.x), looping over j with a __syncthreads() between the
// dependent parts of a step.  The panel, L and W live in global memory
// (6 x 256 KB at B = 256: L2-resident; not in 227 KB of shared memory);
// the scaled column, L's row j and the partial sums live in shared memory.
// No pointer is __restrict__: L and W are read after other threads of the
// block wrote them, which the read-only (non-coherent) cache that
// __restrict__ lets the compiler use would not see.
//
// What bounds it: B = 256 dependent steps, each a synchronised pass over
// the whole panel, about 70 B^3 = 1.2e9 f32 operations in all (~36 per
// entry for the rank-1 update, ~34 for the W row), all on the one SM that
// runs the block: ~128 f32 operations a clock, so ~5 ms a panel at the
// card's clock.  L and W themselves need only about 35 B^3 / 3 = 2.0e8
// of them (the trailing block's lower triangle, W's lower triangle): at
// the card's FMA-free f32 rate over 132 SMs (half its 67 TFLOP/s, which
// counts an FMA as two) that is ~0.006 ms.  A simple design first: the
// serial chain, the one SM and the masked work are what a later redesign
// would attack.
//
// Interface (plain C, loaded with ctypes): ph, pl are [n_inst, B, B]
// contiguous f32 and are overwritten (the panel's trailing state); lh, ll,
// wh, wl are [n_inst, B, B] contiguous f32 outputs (fully written); B is a
// power of two from 32 to 256; the launch goes on the caller's stream,
// nothing is allocated, the return value is a cudaError.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;

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

// Contiguous pairwise sum of leaves q0 .. q0 + 2^D - 1 in bit-reversed
// order: leaf q is row r + G * brev_LM(q) of column k.
template <int D, int LM>
struct Subtree {
  static __device__ __forceinline__ DD sum(int q0, const float* wh,
                                           const float* wl,
                                           const float* rjh, const float* rjl, int r, int G,
                                           int B, int k) {
    const DD a = Subtree<D - 1, LM>::sum(q0, wh, wl, rjh, rjl, r, G, B, k);
    const DD b = Subtree<D - 1, LM>::sum(q0 + (1 << (D - 1)), wh, wl, rjh, rjl, r, G, B, k);
    return tree_node(a, b);
  }
};

template <int LM>
struct Subtree<0, LM> {
  static __device__ __forceinline__ DD sum(int q0, const float* wh,
                                           const float* wl,
                                           const float* rjh, const float* rjl, int r, int G,
                                           int B, int k) {
    int m = 0;
    if constexpr (LM > 0) m = (int)(__brev((unsigned)q0) >> (32 - LM));
    const int i = r + G * m;
    return dd_mul({rjh[i], rjl[i]}, {wh[(size_t)i * B + k], wl[(size_t)i * B + k]});
  }
};

template <int LOGB>
__global__ void __launch_bounds__(kThreads)
dd_panel_kernel(float* ph, float* pl, float* lh, float* ll, float* wh, float* wl) {
  constexpr int B = 1 << LOGB;
  constexpr int BB = B * B;
  constexpr int LG = 10 - LOGB;  // G = 2^LG threads per column of W's row
  constexpr int G = 1 << LG;
  constexpr int LM = LOGB - LG;  // each walks 2^LM rows
  static_assert(G * B == kThreads && LM >= 0, "B must be 32, 64, 128 or 256");

  __shared__ float c_h[B], c_l[B];      // the scaled column j
  __shared__ float r_h[B], r_l[B];      // L[j, i] for i < j, else 0
  __shared__ float part_h[kThreads], part_l[kThreads];  // G partial sums per column

  const size_t off = (size_t)blockIdx.x * BB;
  ph += off;
  pl += off;
  lh += off;
  ll += off;
  wh += off;
  wl += off;
  const int tid = threadIdx.x;

  for (int e = tid; e < BB; e += kThreads) {
    lh[e] = 0.0f;
    ll[e] = 0.0f;
    wh[e] = 0.0f;
    wl[e] = 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < B; ++j) {
    // pivot: every thread computes the same sqrt and inverse
    const DD s = dd_sqrt({ph[j * B + j], pl[j * B + j]});
    const DD is = dd_div({1.0f, 0.0f}, s);
    // column j of L, and row j of L left of the diagonal
    for (int i = tid; i < B; i += kThreads) {
      DD c = dd_mul({ph[i * B + j], pl[i * B + j]}, is);
      if (i < j) c = {0.0f, 0.0f};
      c_h[i] = c.h;
      c_l[i] = c.l;
      lh[i * B + j] = c.h;
      ll[i * B + j] = c.l;
      r_h[i] = i < j ? lh[j * B + i] : 0.0f;
      r_l[i] = i < j ? ll[j * B + i] : 0.0f;
    }
    __syncthreads();
    // rank-1 update of the whole panel
    for (int e = tid; e < BB; e += kThreads) {
      const int i = e >> LOGB, k = e & (B - 1);
      const DD o = dd_mul({c_h[i], c_l[i]}, {c_h[k], c_l[k]});
      const DD p = dd_sub({ph[e], pl[e]}, o);
      ph[e] = p.h;
      pl[e] = p.l;
    }
    // row j of W: partial trees over the residue classes of the rows
    {
      const int k = tid & (B - 1), r = tid >> LOGB;
      const DD v = Subtree<LM, LM>::sum(0, wh, wl, r_h, r_l, r, G, B, k);
      part_h[r * B + k] = v.h;
      part_l[r * B + k] = v.l;
    }
    __syncthreads();
    if (tid < B) {
      const int k = tid;
#pragma unroll
      for (int half = G / 2; half >= 1; half /= 2) {
        for (int i = 0; i < half; ++i) {
          const DD v = tree_node({part_h[i * B + k], part_l[i * B + k]},
                                 {part_h[(i + half) * B + k], part_l[(i + half) * B + k]});
          part_h[i * B + k] = v.h;
          part_l[i * B + k] = v.l;
        }
      }
      const DD u = dd_sub({k == j ? 1.0f : 0.0f, 0.0f}, {part_h[k], part_l[k]});
      const DD w = dd_mul(u, is);
      wh[j * B + k] = w.h;
      wl[j * B + k] = w.l;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dd_panel_launch(void* ph, void* pl, void* lh, void* ll, void* wh, void* wl,
                               int B, int n_inst, void* stream) {
  if (n_inst < 0) return (int)cudaErrorInvalidValue;
  if (n_inst == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  float *a = (float*)ph, *b = (float*)pl, *c = (float*)lh, *d = (float*)ll;
  float *e = (float*)wh, *f = (float*)wl;
  switch (B) {
    case 32: dd_panel_kernel<5><<<n_inst, kThreads, 0, s>>>(a, b, c, d, e, f); break;
    case 64: dd_panel_kernel<6><<<n_inst, kThreads, 0, s>>>(a, b, c, d, e, f); break;
    case 128: dd_panel_kernel<7><<<n_inst, kThreads, 0, s>>>(a, b, c, d, e, f); break;
    case 256: dd_panel_kernel<8><<<n_inst, kThreads, 0, s>>>(a, b, c, d, e, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
