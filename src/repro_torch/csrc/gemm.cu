// Blocked GEMM kernels for Hopper (sm_90a): C = A · B, bf16 operands,
// fp32 accumulation in registers, bf16 or fp32 output.
//
// Replaces the TPU kernels of src/repro/kernels/gemm.py:
//   * gemm_pallas      (gemm.py:182, body _gemm_kernel :166) -> STAGES = 2
//   * gemm_pallas_lean (gemm.py:273, body _gemm_lean_kernel :236) -> STAGES = 1
//
// What bounds it on this card.  On the serving path every call is a decode
// product: M = the slot table (12 rows) against a weight matrix of
// K x N bf16 values, so the work is bound by the bytes of B (2 operations
// per byte, far below the ~295 the H100 needs to be compute-bound).  The
// design therefore (a) streams each B tile into shared memory once with
// 16-byte cp.async copies, two tiles in flight for the pipelined variant,
// (b) masks the ragged M/N/K edges in the kernel instead of padding the
// operands (a padded copy of the 92,544-wide LM head would cost more than
// the product), and (c) leaves the choice of tile shape to the blocking
// derivation (repro_torch/core/blocking.py), which first fills one wave of
// SMs with output tiles.  The inner product runs on the CUDA cores (fp32
// FMA); tensor cores (wgmma), TMA and warp specialisation are later work.
//
// Grid: one block per (BM x BN) output tile; the block loops over K in BK
// slices (the TPU grid's sequential K dimension).  Both variants run the
// same per-element FMA sequence over k = 0 .. K-1, so at equal blocks the
// lean kernel's output is bitwise equal to the pipelined kernel's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAPad = 8;  // A-tile row padding (elements); keeps 16-byte alignment

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + rows) x cols [c0, c0 + cols) of a row-major
// (R x C) bf16 matrix into shared memory with row stride `ld`.  Chunks of
// 8 elements go through cp.async when they lie wholly inside the matrix and
// the rows are 16-byte aligned (`vec`); edge chunks are copied element by
// element and zero-filled past the matrix.
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int R, int C,
    int r0, int c0, int rows, int cols, bool vec) {
  const int chunks_per_row = cols / 8;
  const int n_chunks = rows * chunks_per_row;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    const int r = c / chunks_per_row;
    const int cc = (c % chunks_per_row) * 8;
    const int gr = r0 + r;
    const int gc = c0 + cc;
    __nv_bfloat16* d = dst + r * ld + cc;
    if (vec && gr < R && gc + 8 <= C) {
      cp_async16(d, src + static_cast<size_t>(gr) * C + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < R && gc + e < C) ? src[static_cast<size_t>(gr) * C + gc + e]
                                      : __float2bfloat16(0.0f);
      }
    }
  }
}

// Thread layout of a (BM x BN) tile: TX x TY threads, each owning TM rows
// (strided by TY) and TN adjacent columns.
template <int BM, int BN>
struct Layout {
  static constexpr int kOut = BM * BN / kThreads;
  static constexpr int TN = kOut >= 4 ? 4 : kOut;
  static constexpr int TM = kOut / TN;
  static constexpr int TX = BN / TN;
  static constexpr int TY = kThreads / TX;
  static_assert(kOut >= 1 && TM * TY == BM && TX * TY == kThreads, "bad tile");
};

// acc += A_tile · B_tile over kk = 0 .. bk-1, one FMA per element per kk
// in increasing kk — shared by both variants (the bitwise contract).
template <int BM, int BN>
__device__ __forceinline__ void mma_tile(
    const __nv_bfloat16* As, const __nv_bfloat16* Bs, int bk, int ty, int tx,
    float (&acc)[Layout<BM, BN>::TM][Layout<BM, BN>::TN]) {
  using L = Layout<BM, BN>;
  const int lda = bk + kAPad;
#pragma unroll 4
  for (int kk = 0; kk < bk; ++kk) {
    float a[L::TM];
    float b[L::TN];
#pragma unroll
    for (int i = 0; i < L::TM; ++i) a[i] = __bfloat162float(As[(ty + i * L::TY) * lda + kk]);
    const __nv_bfloat16* brow = Bs + kk * BN + tx * L::TN;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) b[j] = __bfloat162float(brow[j]);
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int j = 0; j < L::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            void* __restrict__ C, int M, int K, int N, int bk, int out_f32,
            int a_vec, int b_vec) {
  using L = Layout<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_elems = BM * (bk + kAPad);
  const int stage_elems = a_elems + bk * BN;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % L::TX;
  const int ty = threadIdx.x / L::TX;

  float acc[L::TM][L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.0f;

  const int n_k = (K + bk - 1) / bk;
  auto stage = [&](int t, int buf) {
    __nv_bfloat16* As = base + buf * stage_elems;
    __nv_bfloat16* Bs = As + a_elems;
    stage_tile(As, bk + kAPad, A, M, K, m0, t * bk, BM, bk, a_vec);
    stage_tile(Bs, BN, B, K, N, t * bk, n0, bk, BN, b_vec);
    cp_async_commit();
  };

  if (STAGES == 2) {
    // Two-stage ring: tile t+1 is in flight while tile t is multiplied.
    stage(0, 0);
    for (int t = 0; t < n_k; ++t) {
      if (t + 1 < n_k) {
        stage(t + 1, (t + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* As = base + (t & 1) * stage_elems;
      mma_tile<BM, BN>(As, As + a_elems, bk, ty, tx, acc);
      __syncthreads();
    }
  } else {
    // Lean: one A/B pair — load, wait, multiply (no overlap).
    for (int t = 0; t < n_k; ++t) {
      stage(t, 0);
      cp_async_wait<0>();
      __syncthreads();
      mma_tile<BM, BN>(base, base + a_elems, bk, ty, tx, acc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int gm = m0 + ty + i * L::TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int gn = n0 + tx * L::TN + j;
      if (gn >= N) continue;
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (out_f32) {
        static_cast<float*>(C)[o] = acc[i][j];
      } else {
        static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16(acc[i][j]);
      }
    }
  }
}

template <int BM, int BN, int STAGES>
int launch(const void* a, const void* b, void* c, int m, int k, int n, int bk,
           int out_f32, int a_vec, int b_vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(STAGES) *
                      (BM * (bk + kAPad) + bk * BN) * sizeof(__nv_bfloat16);
  static size_t opted_in = 0;  // per instantiation: raise the limit once
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BM, BN, STAGES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
    opted_in = smem;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<BM, BN, STAGES><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), c,
      m, k, n, bk, out_f32, a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one GEMM on `stream`.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a tile shape that was not compiled).
int repro_gemm(const void* a, const void* b, void* c, int m, int k, int n,
               int bm, int bk, int bn, int stages, int out_f32, int a_vec,
               int b_vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk <= 0 || bk % 8 != 0 || (stages != 1 && stages != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_GEMM_CASE(BM_, BN_)                                                   \
  if (bm == BM_ && bn == BN_) {                                                     \
    return stages == 2 ? launch<BM_, BN_, 2>(a, b, c, m, k, n, bk, out_f32, a_vec,  \
                                             b_vec, s)                              \
                       : launch<BM_, BN_, 1>(a, b, c, m, k, n, bk, out_f32, a_vec,  \
                                             b_vec, s);                             \
  }
  REPRO_GEMM_CASE(16, 32)
  REPRO_GEMM_CASE(16, 64)
  REPRO_GEMM_CASE(16, 128)
  REPRO_GEMM_CASE(16, 256)
  REPRO_GEMM_CASE(32, 32)
  REPRO_GEMM_CASE(32, 64)
  REPRO_GEMM_CASE(32, 128)
  REPRO_GEMM_CASE(32, 256)
  REPRO_GEMM_CASE(64, 32)
  REPRO_GEMM_CASE(64, 64)
  REPRO_GEMM_CASE(64, 128)
  REPRO_GEMM_CASE(64, 256)
  REPRO_GEMM_CASE(128, 32)
  REPRO_GEMM_CASE(128, 64)
  REPRO_GEMM_CASE(128, 128)
#undef REPRO_GEMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
