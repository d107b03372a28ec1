// Ozaki-scheme slice-pair accumulation for hpmm (f64-grade A @ B from
// bf16 mantissa slices), as a hand-written CUDA kernel for sm_90a (K1).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   hdsdp_tpu/ops/hpmm.py  _mm_kernel_factory (:162), driven by
//   _matmul_sliced_pallas (:199).
//
// What it computes, per output element (i, j) and per 256-wide K chunk c,
// in exactly the fold order of the reference scan _matmul_sliced
// (:124-141):
//   p_tu = sum_{k in chunk} a[t, i, k] * b[u, k, j]     (f32, t + u <= gmax)
//   for g = 0..gmax, t = 0..g, u = g - t:
//     g <= 3: (ch, cl) <- quick_two_sum(two_sum(ch, p_tu) ...)   (DD fold)
//     g >= 4: high += p_tu                                        (f32)
//   gmax >= 4: fold high into (ch, cl) once per chunk.
// and then one of three epilogues:
//   (Ch, Cl) as they are;
//   (Ch * s, Cl * s) with the f32 scale s = 2^ea[i] * 2^eb[j];
//   the f64 product C = ((double)Ch + (double)Cl) * 2^ea[i] * 2^eb[j].
//
// Exactness, and why the in-chunk sums run on the tensor cores: slice t
// holds an integer of magnitude <= 256 times the unit 2^-8(t+1), so every
// bf16 x bf16 product of a pair (t, u) is an integer multiple of the pair's
// unit, and every partial sum inside one 256-wide chunk, in any order and
// grouping, is such a multiple of magnitude <= 2^24 units.  A tensor-core
// MMA aligns its addends to the largest exponent and keeps at least the 24
// bits of an f32 result below it, so no set bit of any addend falls out of
// the kept window: mma.sync with bf16 inputs and f32 accumulators that
// start from zero for every (pair, chunk) gives the exact p_tu, bit for
// bit those of the reference.  The order-sensitive DD folds stay on the
// CUDA cores with __fadd_rn/__fsub_rn, which the compiler never contracts
// or reassociates, in the reference order.  Build without --use_fast_math.
// The card is held to this by bitwise comparison with the plain PyTorch
// version (matmul_sliced_ref), including slices that are all +-256 units,
// where the chunk sums reach 2^24 units.
//
// Design for an H100, and what bounds it.  The work is (gmax+1)(gmax+2)/2
// bf16 MMAs per output tile and K step (21 at gmax = 5): far above the
// card's 295 operations per byte of device memory, so the yardstick is the
// tensor-core rate (0.0055 ms at [501,512] x [512,501]).  What keeps the
// kernel from it is the register file: every pair needs its own f32
// accumulator until the chunk's fold, so a warp can own no more than a
// 16 x 8 output tile (84 accumulators at gmax = 5), and a fragment loaded
// from shared memory feeds at most q MMAs.  Per block and 32-deep stage
// the warps read 72 KB of fragments and cp.async writes 30 KB, 816 cycles
// of the SM's 128 bytes a cycle against 336 cycles of MMA time: shared-
// memory bandwidth bounds this design at about 0.014 ms, and it measures
// 0.030 ms (PERF.md).  What the kernel does about it:
//   - one warp owns a 16 x 8 output tile and keeps all pair accumulators in
//     registers, so the q A-fragments and q B-fragments of a 16-deep K step
//     feed every pair's MMA: 2q ldmatrix for 21 MMAs (the TPU kernel, and
//     a pair-by-pair loop, would reload both operands for every pair);
//   - a block is 8 warps (2 x 4) on a 32 x 32 tile, capped at 128 registers
//     up to gmax = 5 so two blocks live on an SM: 501 x 501 gives 256
//     blocks for 264 slots, one wave (gmax 6, 7 need more registers and
//     run one block per SM);
//   - operands stay bf16 in shared memory, K-contiguous rows of 32 values
//     padded to 80 bytes (conflict-free ldmatrix), filled 16 bytes a thread
//     by cp.async in a 3-stage ring with one barrier per stage, so the
//     loads of K steps s+1, s+2 overlap the MMAs of step s;
//   - B is read as the "col" operand: its slices are wanted K-contiguous
//     ([q, N, K] storage, passed as the transposed view), as the slicing
//     kernel stores them.
//
// A fleet of `batch` same-shape products (the vmapped TPU function, whose
// Pallas grid gains one axis) is one launch: blockIdx.z picks the instance,
// whose operands and output start `s*_b` elements further on and whose
// exponents are the next M and N entries of ea and eb.  The tile loop is
// untouched, so each instance's output is bitwise that of its own launch.
//
// Interface (plain C, loaded with ctypes): strides are in elements, the
// ragged M and N edges are masked here, K must be a multiple of 256 (the
// caller zero-pads), 0 <= gmax <= 7, the launch goes on the caller's
// stream, nothing is allocated, and the return value is a cudaError
// (cudaErrorInvalidValue for an unsupported gmax, a missing output, or an
// operand that cp.async cannot stage: both operands must be K-contiguous
// with 16-byte-aligned rows, i.e. a base address, a slice stride and a row
// stride that are multiples of 8 elements).
// c64 != null selects the f64 epilogue (ea, eb required; ch, cl unused);
// otherwise (ch, cl) are written, scaled when ea and eb are given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;   // exact in-chunk accumulation width
constexpr int kBM = 32;       // output rows per block
constexpr int kBN = 32;       // output cols per block
constexpr int kBK = 32;       // K depth per pipeline stage
constexpr int kRow = kBK + 8; // bf16 per shared-memory row (80 bytes)
constexpr int kStages = 3;
constexpr int kThreads = 256; // 8 warps: 2 along M x 4 along N

struct Params {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* ch;
  float* cl;
  double* c64;
  const int* ea;
  const int* eb;
  int M, N, K;
  long long sa_b, sa_q, sa_m;  // in elements; K is contiguous in both operands
  long long sb_b, sb_q, sb_n;
  long long sc_b, sc_m, sc_n;
};

__device__ __forceinline__ void dd_fold(float& ch, float& cl, float p) {
  // two_sum(ch, p)
  const float s = __fadd_rn(ch, p);
  const float bb = __fsub_rn(s, ch);
  const float e = __fadd_rn(__fsub_rn(ch, __fsub_rn(s, bb)), __fsub_rn(p, bb));
  // quick_two_sum(s, e + cl)
  const float t = __fadd_rn(e, cl);
  const float s2 = __fadd_rn(s, t);
  cl = __fsub_rn(t, __fsub_rn(s2, s));
  ch = s2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int GMAX>
__global__ void __launch_bounds__(kThreads, GMAX <= 5 ? 2 : 1)
hpmm_pairs_kernel(Params p) {
  constexpr int kQ = GMAX + 1;  // slices used per operand
  constexpr int kPairs = (GMAX + 1) * (GMAX + 2) / 2;
  constexpr int kSlice = kBM * kRow;        // elements of one slice of one operand
  constexpr int kOperand = kQ * kSlice;     // one operand, one stage
  constexpr int kStage = 2 * kOperand;      // A then B
  static_assert(kBM == kBN, "the loader treats both operands alike");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // this block's instance of the fleet
  p.a += (long long)blockIdx.z * p.sa_b;
  p.b += (long long)blockIdx.z * p.sb_b;
  if (p.c64 != nullptr) p.c64 += (long long)blockIdx.z * p.sc_b;
  if (p.ch != nullptr) p.ch += (long long)blockIdx.z * p.sc_b;
  if (p.cl != nullptr) p.cl += (long long)blockIdx.z * p.sc_b;
  if (p.ea != nullptr) p.ea += (long long)blockIdx.z * p.M;
  if (p.eb != nullptr) p.eb += (long long)blockIdx.z * p.N;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  // loader role: threads 0..127 stage A, 128..255 stage B; each owns one
  // 16-byte piece (8 K values) of one tile row, for every slice
  const int l_op = tid >> 7;
  const int l_row = (tid & 127) >> 2;
  const int l_piece = tid & 3;
  const int l_grow = (l_op ? col0 : row0) + l_row;
  const bool l_valid = l_grow < (l_op ? p.N : p.M);
  const long long l_sq = l_op ? p.sb_q : p.sa_q;
  const long long l_sr = l_op ? p.sb_n : p.sa_m;
  const __nv_bfloat16* l_base = (l_op ? p.b : p.a) +
                                (l_valid ? (long long)l_grow * l_sr : 0) +
                                l_piece * 8;
  const int l_dst = l_op * kOperand + l_row * kRow + l_piece * 8;

  auto load_stage = [&](int slot, int kt) {
    const __nv_bfloat16* src = l_base + (long long)kt * kBK;
    __nv_bfloat16* dst = smem + slot * kStage + l_dst;
#pragma unroll
    for (int t = 0; t < kQ; ++t) {
      cp_async16(smem_u32(dst + t * kSlice), src + t * l_sq, l_valid ? 16 : 0);
    }
  };

  // ldmatrix byte offsets inside a stage, for slice 0 and K step 0
  const uint32_t smem_base = smem_u32(smem);
  const uint32_t a_off = ((wm * 16 + (lane & 15)) * kRow + (lane >> 4) * 8) * 2;
  const uint32_t b_off =
      (kOperand + (wn * 8 + (lane & 7)) * kRow + ((lane >> 3) & 1) * 8) * 2;

  // acc[g(g+1)/2 + t] = in-chunk sum of slice pair (t, g - t); per thread the
  // MMA's four values: rows lane/4 and lane/4 + 8, cols 2(lane%4) and + 1
  float acc[kPairs][4];
  float ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  }

  const int nk = p.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();               // ... everyone's, and stage kt-1 is consumed
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const uint32_t st = smem_base + (uint32_t)((kt % kStages) * kStage * 2);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bfr[kQ][2];
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        ldmatrix_x2(bfr[u], st + b_off + (uint32_t)((u * kSlice + ks * 16) * 2));
      }
#pragma unroll
      for (int t = 0; t < kQ; ++t) {
        uint32_t afr[4];
        ldmatrix_x4(afr, st + a_off + (uint32_t)((t * kSlice + ks * 16) * 2));
#pragma unroll
        for (int u = 0; u + t <= GMAX; ++u) {
          mma_bf16(acc[(t + u) * (t + u + 1) / 2 + t], afr, bfr[u]);
        }
      }
    }

    if ((kt + 1) % (kChunk / kBK) == 0) {
      // fold the chunk's pairs in the reference order, restart the sums
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float high = 0.0f;
#pragma unroll
        for (int g = 0; g <= GMAX; ++g) {
#pragma unroll
          for (int t = 0; t <= g; ++t) {
            const float pv = acc[g * (g + 1) / 2 + t][e];
            acc[g * (g + 1) / 2 + t][e] = 0.0f;
            if (g <= 3) {
              dd_fold(ch[e], cl[e], pv);
            } else if (g == 4 && t == 0) {
              high = pv;  // the reference starts high at its first pair
            } else {
              high = __fadd_rn(high, pv);
            }
          }
        }
        if (GMAX >= 4) dd_fold(ch[e], cl[e], high);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + wm * 16 + (lane >> 2) + 8 * (e >> 1);
    const int c = col0 + wn * 8 + 2 * (lane & 3) + (e & 1);
    if (r >= p.M || c >= p.N) continue;
    const long long off = (long long)r * p.sc_m + (long long)c * p.sc_n;
    if (p.c64 != nullptr) {
      const double pa = (double)ldexpf(1.0f, p.ea[r]);
      const double pb = (double)ldexpf(1.0f, p.eb[c]);
      const double v = __dadd_rn((double)ch[e], (double)cl[e]);
      p.c64[off] = __dmul_rn(__dmul_rn(v, pa), pb);
    } else if (p.ea != nullptr) {
      const float s = __fmul_rn(ldexpf(1.0f, p.ea[r]), ldexpf(1.0f, p.eb[c]));
      p.ch[off] = __fmul_rn(ch[e], s);
      p.cl[off] = __fmul_rn(cl[e], s);
    } else {
      p.ch[off] = ch[e];
      p.cl[off] = cl[e];
    }
  }
}

template <int GMAX>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = kStages * 2 * (GMAX + 1) * kBM * kRow * 2;
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(hpmm_pairs_kernel<GMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM, batch);
  hpmm_pairs_kernel<GMAX><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// rows of 8 K values can be copied 16 bytes at a time
bool stageable(const void* base, long long s_b, long long s_q, long long s_row,
               long long s_k) {
  return s_k == 1 && s_b % 8 == 0 && s_q % 8 == 0 && s_row % 8 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

}  // namespace

extern "C" int hpmm_pairs_launch(const void* a, const void* b, void* ch, void* cl,
                                 void* c64, const void* ea, const void* eb,
                                 int M, int N, int K, int gmax, int batch,
                                 long long sa_b, long long sa_q, long long sa_m,
                                 long long sa_k, long long sb_b, long long sb_q,
                                 long long sb_k, long long sb_n, long long sc_b,
                                 long long sc_m, long long sc_n, void* stream) {
  if (K % kChunk != 0 || (ea == nullptr) != (eb == nullptr) ||
      (c64 != nullptr && ea == nullptr) ||
      (c64 == nullptr && (ch == nullptr || cl == nullptr)) || batch > 65535 ||
      !stageable(a, sa_b, sa_q, sa_m, sa_k) || !stageable(b, sb_b, sb_q, sb_n, sb_k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M <= 0 || N <= 0 || batch <= 0) return (int)cudaGetLastError();
  Params p;
  p.a = (const __nv_bfloat16*)a;
  p.b = (const __nv_bfloat16*)b;
  p.ch = (float*)ch;
  p.cl = (float*)cl;
  p.c64 = (double*)c64;
  p.ea = (const int*)ea;
  p.eb = (const int*)eb;
  p.M = M;
  p.N = N;
  p.K = K;
  p.sa_b = sa_b;
  p.sa_q = sa_q;
  p.sa_m = sa_m;
  p.sb_b = sb_b;
  p.sb_q = sb_q;
  p.sb_n = sb_n;
  p.sc_b = sc_b;
  p.sc_m = sc_m;
  p.sc_n = sc_n;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (gmax) {
    case 0: return (int)launch<0>(p, batch, s);
    case 1: return (int)launch<1>(p, batch, s);
    case 2: return (int)launch<2>(p, batch, s);
    case 3: return (int)launch<3>(p, batch, s);
    case 4: return (int)launch<4>(p, batch, s);
    case 5: return (int)launch<5>(p, batch, s);
    case 6: return (int)launch<6>(p, batch, s);
    case 7: return (int)launch<7>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
