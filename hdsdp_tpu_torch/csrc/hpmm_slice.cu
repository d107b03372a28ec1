// Operand slicing for the Ozaki hpmm (K1s): one f64 matrix (or one f32
// double-single pair) in, q bf16 mantissa slices and the power-of-two
// exponents of its row (or column) scales out, in one launch.
//
// A helper kernel of the same TPU function as K1: it replaces the
// elementwise prologue that the JAX package leaves to XLA around its Pallas
// kernel (hdsdp_tpu/ops/hpmm.py: _exp_of :45, _pow2 :58, _normalize_dd :63,
// _slices :78, _pad_k :101, as used by _hpmm_f64_impl :297-305), and that
// the port ran as ~20 separate elementwise launches per operand.
//
// What it computes, for a logical matrix X[i, k] given by two strides (the
// wrapper swaps them to slice along rows or along columns):
//   m_i  = max_k |X[i, k]|                     (NaN propagates)
//   e_i  = frexp exponent of float(clamp(m_i, 2^-120, 2^120)); 0 for NaN
//   n    = X[i, k] * 2^-e_i                    (f64, exact)
//   (rh, rl) = (float(n), float(n - float(n)))
//   for t = 0..q-1:
//     s  = trunc(rh * 2^(8(t+1))) * 2^(-8(t+1));  out[t, i, k] = bf16(s)
//     (rh, rl) = two_sum(rh - s, rl)
// with out[t, i, k] = 0 for K <= k < Kp (the zero padding to a multiple of
// 256 that K1 wants).  The double-single entry takes (h, l) f32, takes the
// maximum over |h|, and scales both by 2^-e_i in f32 instead of splitting
// an f64.  Every operation is the IEEE one the plain PyTorch version
// (slice_ref) performs, in its order: __fadd_rn/__fsub_rn/__fmul_rn are
// never contracted or reassociated, and there is no --use_fast_math, so the
// slices and exponents are bit-identical to it.
//
// What bounds it on an H100: bytes.  It reads 8 bytes and writes 2q bytes
// per element (2 MB in, 3 MB out at 501 x 500, q = 6), about a microsecond
// and a half at the card's memory rate, and does ~15 flops per slice.  A
// block owns 8 rows i and walks K in tiles of 512 through shared memory: the
// tile is loaded along whichever of the two strides is the smaller, so a
// transposed view (column scales of a row-major B, or A given as W^T) is
// read in contiguous runs and never with one long stride per thread; the
// slices are always written along k, two to a thread (4-byte stores, 128
// bytes a warp).  When K fits one tile (K <= 512, the main path's shapes)
// the tile loaded for the maximum is reused for the slicing, so the input is
// read from device memory once.
//
// A fleet of `batch` same-shape operands (the vmapped form of the TPU
// function) is one launch: blockIdx.y picks the instance, whose input
// starts `s*_b` elements further on and whose slices and exponents are the
// next [q, I, Kp] and [I] blocks of out and e.  Nothing else changes, so
// each instance's output is bitwise what its own launch gives.
//
// Interface (plain C, loaded with ctypes): strides in elements; out is
// [batch, q, I, Kp] contiguous bf16, e is [batch, I] int32; lo == null
// selects the f64 entry; the launch goes on the caller's stream, nothing is
// allocated, the return value is a cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;       // rows i per block, one warp each
constexpr int kTile = 512;     // K values per shared-memory tile
constexpr int kThreads = 256;
constexpr int kMaxQ = 8;

// one staged element: the f64 value, or the double-single pair
struct F64Cell {
  double v;
};
struct DDCell {
  float h, l;
};

__device__ __forceinline__ double cell_abs(const F64Cell& c) { return fabs(c.v); }
__device__ __forceinline__ float cell_abs(const DDCell& c) { return fabsf(c.h); }

// max that keeps a NaN once it has seen one, as torch.amax / jnp.max do
template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  return (m != m || v <= m) ? m : v;
}

template <typename T>
__device__ __forceinline__ T clamp_keep_nan(T m, T lo, T hi) {
  if (m != m) return m;
  return m < lo ? lo : (m > hi ? hi : m);
}

__device__ __forceinline__ float pow2f(int e) {  // exact 2^e, |e| <= 126
  return __int_as_float((127 + e) << 23);
}

// normalized (rh, rl) of one element, given the row's exponent
__device__ __forceinline__ void normalize(const F64Cell& c, int e, float& rh, float& rl) {
  const double n = __dmul_rn(c.v, (double)pow2f(-e));
  rh = __double2float_rn(n);
  rl = __double2float_rn(__dsub_rn(n, (double)rh));
}
__device__ __forceinline__ void normalize(const DDCell& c, int e, float& rh, float& rl) {
  const float inv = pow2f(-e);
  rh = __fmul_rn(c.h, inv);
  rl = __fmul_rn(c.l, inv);
}

// slice t of (rh, rl), and the remainder for slice t + 1
__device__ __forceinline__ float next_slice(float& rh, float& rl, int t) {
  const float s = __fmul_rn(truncf(__fmul_rn(rh, pow2f(8 * (t + 1)))), pow2f(-8 * (t + 1)));
  // two_sum(rh - s, rl)
  const float a = __fsub_rn(rh, s);
  const float sum = __fadd_rn(a, rl);
  const float bb = __fsub_rn(sum, a);
  rl = __fadd_rn(__fsub_rn(a, __fsub_rn(sum, bb)), __fsub_rn(rl, bb));
  rh = sum;
  return s;
}

template <typename Cell>
struct Source;
template <>
struct Source<F64Cell> {
  const double* x;
  long long s_b, s_i, s_k;
  __device__ __forceinline__ Source at(long long b) const {
    return Source{x + b * s_b, s_b, s_i, s_k};
  }
  __device__ __forceinline__ F64Cell load(long long i, long long k) const {
    return F64Cell{x[i * s_i + k * s_k]};
  }
  __device__ __forceinline__ static F64Cell zero() { return F64Cell{0.0}; }
};
template <>
struct Source<DDCell> {
  const float* h;
  const float* l;
  long long s_b, s_i, s_k, sl_b, sl_i, sl_k;
  __device__ __forceinline__ Source at(long long b) const {
    return Source{h + b * s_b, l + b * sl_b, s_b, s_i, s_k, sl_b, sl_i, sl_k};
  }
  __device__ __forceinline__ DDCell load(long long i, long long k) const {
    return DDCell{h[i * s_i + k * s_k], l[i * sl_i + k * sl_k]};
  }
  __device__ __forceinline__ static DDCell zero() { return DDCell{0.0f, 0.0f}; }
};

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
hpmm_slice_kernel(const Source<Cell> src0, __nv_bfloat16* __restrict__ out,
                  int* __restrict__ e_out, int I, int K, int Kp, int q) {
  __shared__ Cell tile[kRows][kTile + 1];
  using Mag = decltype(cell_abs(Cell{}));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // the row of the tile this warp reduces and slices
  const int i0 = blockIdx.x * kRows;
  const Source<Cell> src = src0.at(blockIdx.y);  // this block's instance
  out += (long long)blockIdx.y * q * I * Kp;
  e_out += (long long)blockIdx.y * I;
  const int ntiles = (Kp + kTile - 1) / kTile;
  const bool k_fast = src.s_k <= src.s_i;  // which index runs along the threads

  auto load_tile = [&](int k0) {
    for (int idx = tid; idx < kRows * kTile; idx += kThreads) {
      const int r = k_fast ? idx / kTile : idx % kRows;
      const int c = k_fast ? idx % kTile : idx / kRows;
      const bool in = i0 + r < I && k0 + c < K;
      tile[r][c] = in ? src.load(i0 + r, k0 + c) : Source<Cell>::zero();
    }
  };

  // pass 1: the row maxima
  Mag m = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt > 0) __syncthreads();  // the previous tile is consumed
    load_tile(kt * kTile);
    __syncthreads();
    for (int c = lane; c < kTile; c += 32) m = nan_max(m, cell_abs(tile[warp][c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  int e = 0;
  {
    const float mf = (float)clamp_keep_nan(m, (Mag)0x1p-120, (Mag)0x1p120);
    if (mf == mf) frexpf(mf, &e);
  }
  const int i = i0 + warp;
  if (lane == 0 && i < I) e_out[i] = e;

  // pass 2: the slices, written along k
  for (int kt = 0; kt < ntiles; ++kt) {
    if (ntiles > 1) {
      __syncthreads();
      load_tile(kt * kTile);
      __syncthreads();
    }
    if (i >= I) continue;
    for (int c = 2 * lane; c < kTile; c += 64) {
      const int k = kt * kTile + c;
      if (k >= Kp) break;
      float rh0, rl0, rh1, rl1;
      normalize(tile[warp][c], e, rh0, rl0);
      normalize(tile[warp][c + 1], e, rh1, rl1);
      __nv_bfloat16* dst = out + (long long)i * Kp + k;
      for (int t = 0; t < q; ++t) {
        const float s0 = next_slice(rh0, rl0, t);
        const float s1 = next_slice(rh1, rl1, t);
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)t * I * Kp) =
            __halves2bfloat162(__float2bfloat16_rn(s0), __float2bfloat16_rn(s1));
      }
    }
  }
}

}  // namespace

extern "C" int hpmm_slice_launch(const void* x, const void* lo, void* out, void* e,
                                 int I, int K, int Kp, int q, int batch,
                                 long long sx_b, long long sx_i, long long sx_k,
                                 long long sl_b, long long sl_i, long long sl_k,
                                 void* stream) {
  if (q < 1 || q > kMaxQ || Kp < K || Kp % 2 != 0 || K < 0 || batch > 65535 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (I <= 0 || Kp == 0 || batch <= 0) return (int)cudaGetLastError();
  const dim3 grid((I + kRows - 1) / kRows, batch);
  const cudaStream_t s = (cudaStream_t)stream;
  if (lo == nullptr) {
    Source<F64Cell> src{(const double*)x, sx_b, sx_i, sx_k};
    hpmm_slice_kernel<F64Cell><<<grid, kThreads, 0, s>>>(
        src, (__nv_bfloat16*)out, (int*)e, I, K, Kp, q);
  } else {
    Source<DDCell> src{(const float*)x, (const float*)lo, sx_b, sx_i, sx_k, sl_b, sl_i, sl_k};
    hpmm_slice_kernel<DDCell><<<grid, kThreads, 0, s>>>(
        src, (__nv_bfloat16*)out, (int*)e, I, K, Kp, q);
  }
  return (int)cudaGetLastError();
}
