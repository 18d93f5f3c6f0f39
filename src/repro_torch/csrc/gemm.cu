// Blocked GEMM kernels for Hopper (sm_90a): C = A · B, bf16 operands,
// fp32 accumulation on the tensor cores, bf16 or fp32 output.
//
// Replaces the TPU kernels of src/repro/kernels/gemm.py:
//   * gemm_pallas      (gemm.py:182, body _gemm_kernel :166) -> a ring of `stages` >= 2
//   * gemm_pallas_lean (gemm.py:273, body _gemm_lean_kernel :236) -> stages = 1
//
// What bounds it on this card.  The full-sequence forward multiplies
// M = 4096 rows against weights of K x N in the thousands: about 770
// operations per byte, far above the ~295 the H100 needs to be
// compute-bound, so there only the tensor cores (989 TFLOP/s in bf16, 15x
// the CUDA cores' fp32 rate) can bring it near its bound.  The decode step
// multiplies M = 12 rows: 2 operations per byte of B, bound by the bytes of
// the weights, where the tile shape must fill the SMs (the blocking
// derivation in repro_torch/core/blocking.py does that first).
//
// The design.  One block per (BM x BN) output tile, BM in {64, 128}: one
// consumer warpgroup per 64 rows plus one producer warpgroup.  One thread
// of the producer issues TMA loads of the A (BM x bk) and B (bk x BN)
// tiles into a ring of `stages` shared-memory stages, each guarded by a
// full and an empty mbarrier; the loads land in the 128-byte swizzle
// (64-byte for BN = 32) that wgmma reads without bank conflicts, and TMA
// zero-fills whatever lies past M, N or K, so ragged edges cost no extra
// bytes and need no masks on the load side.  The consumers run
// wgmma.mma_async m64nBNk16 from shared memory (A K-major, B MN-major: B is
// the (K, N) row-major weight as it lies in memory), keep the sum in fp32
// registers and store the ragged M/N edge under a mask.  The lean instance
// is the same kernel with one stage (load, wait, multiply, release); both
// issue the same wgmma sequence over k = 0 .. K-1, so at equal blocks the
// lean output is bitwise equal to the pipelined one.  Not persistent and no
// clusters yet: one output tile per block.
//
// TMA needs 16-byte row strides (K and N multiples of 8) and 16-byte
// aligned bases; the wrapper (repro_torch/kernels/gemm.py) makes a
// zero-padded copy of an operand that has neither.  The tensor maps are
// encoded on the host per call through the driver's cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint (no link against libcuda).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroup = 128;  // threads of one warpgroup
constexpr int kSwizzleK = 64;    // bf16 values in one 128-byte swizzle row
constexpr int kGroupM = 16;      // output tiles raster in groups of 16 tile rows (L2 reuse)
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may claim on an H100

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Block until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// A, K-major (a row of 64 values is one 128-byte swizzle row; 8 rows make
// a 1024-byte atom): the 16 values of k-step kk start 2 * (kk % 64) bytes
// into the row, in the box of columns kk / 64.
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tile, int bm, int kk) {
  return smem_desc(a_tile + (kk / kSwizzleK) * bm * 128 + (kk % kSwizzleK) * 2, 16, 1024, 1);
}

// B, MN-major: B's rows are k, each a swizzle row of `width` N-values
// (64, or 32 for BN = 32), boxes of `width` columns `bk` rows deep.  The
// stride between 8-row k groups is 8 rows; between width-wide column boxes,
// one box (the leading byte offset of an MN-major operand).
template <int BN>
__device__ __forceinline__ uint64_t b_desc(uint32_t b_tile, int bk, int kk) {
  constexpr int width = BN < kSwizzleK ? BN : kSwizzleK;
  constexpr uint32_t row = width * 2;
  return smem_desc(b_tile + kk * row, bk * row, 8 * row, BN < kSwizzleK ? 2 : 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N) += A(64 x 16, K-major) . B(16 x N, MN-major), fp32 sum in d.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * kWarpgroup, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            void* __restrict__ C, int M, int K, int N, int bk, int stages, int out_f32) {
  constexpr int kConsumers = BM / 64;
  constexpr int kAcc = BN / 2;
  constexpr int kBoxN = BN < kSwizzleK ? BN : kSwizzleK;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int a_bytes = BM * bk * 2;
  const int stage_bytes = a_bytes + bk * BN * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;

  // Grouped raster: kGroupM tile rows walk all tile columns together, so
  // the blocks resident at once share their A rows and B columns in L2.
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int per_group = kGroupM * n_tiles;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int rows = min(m_tiles - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows) * BM;
  const int n0 = (in_group / rows) * BN;
  const int n_k = (K + bk - 1) / bk;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup: one thread keeps the ring full.
    if (BM == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * kWarpgroup) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % stages;
        const int round = t / stages;
        if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
        const uint32_t bar = smem_addr(full + s);
        const uint32_t a_tile = smem_addr(smem + s * stage_bytes);
        const uint32_t b_tile = a_tile + a_bytes;
        const int k0 = t * bk;
        mbar_expect_tx(bar, stage_bytes);
        for (int j = 0; j < bk / kSwizzleK; ++j) {
          tma_load(a_tile + j * BM * 128, &map_a, bar, k0 + j * kSwizzleK, m0);
        }
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j) {
          tma_load(b_tile + j * bk * kBoxN * 2, &map_b, bar, n0 + j * kBoxN, k0);
        }
      }
    }
  } else {
    // Consumer warpgroup `wg`: rows [64 wg, 64 wg + 64) of the tile.
    if (BM == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int t = 0; t < n_k; ++t) {
      const int s = t % stages;
      mbar_wait(smem_addr(full + s), (t / stages) & 1);
      const uint32_t a_tile = smem_addr(smem + s * stage_bytes) + wg * 64 * 128;
      const uint32_t b_tile = smem_addr(smem + s * stage_bytes) + a_bytes;
      wgmma_fence();
      for (int kk = 0; kk < bk; kk += 16) {
        wgmma<BN>(acc, a_desc(a_tile, BM, kk), b_desc<BN>(b_tile, bk, kk));
      }
      wgmma_commit();
      // With a ring, keep this stage's products in flight and release the
      // previous stage; with one stage, drain and release it (lean).  The
      // wgmma sequence, and so the sum, is the same either way.
      if (stages > 1) {
        wgmma_wait<1>();
        if (t > 0 && threadIdx.x % kWarpgroup == 0) {
          mbar_arrive(smem_addr(empty + (t - 1) % stages));
        }
      } else {
        wgmma_wait<0>();
        if (threadIdx.x % kWarpgroup == 0) mbar_arrive(smem_addr(empty + s));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Epilogue: the wgmma accumulator layout — warp w of the warpgroup
    // holds rows 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1).
    const int lane = threadIdx.x % 32;
    const int row0 = m0 + wg * 64 + ((threadIdx.x % kWarpgroup) / 32) * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= M || col >= N) continue;
        const float v0 = acc[4 * j + 2 * i];
        const float v1 = acc[4 * j + 2 * i + 1];
        const size_t o = static_cast<size_t>(row) * N + col;
        if (out_f32) {
          float* c = static_cast<float*>(C) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
          } else {
            c[0] = v0;
            if (col + 1 < N) c[1] = v1;
          }
        } else {
          __nv_bfloat16* c = static_cast<__nv_bfloat16*>(C) + o;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v0, v1);
          } else {
            c[0] = __float2bfloat16(v0);
            if (col + 1 < N) c[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A row-major (rows x cols) bf16 matrix read in boxes of (box_rows x box_cols).
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows, int box_cols,
            CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
int launch(const void* a, const void* b, void* c, int m, int k, int n, int ldb, int bk,
           int stages, int out_f32, cudaStream_t stream) {
  constexpr int kBoxN = BN < kSwizzleK ? BN : kSwizzleK;
  const int smem = stages * ((BM * bk + bk * BN) * 2 + 16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, a, m, k, BM, kSwizzleK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_b, b, k, ldb, bk, kBoxN,
              BN < kSwizzleK ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;  // per instantiation: raise the limit once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BM, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
    opted_in = true;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  gemm_kernel<BM, BN><<<tiles, (BM / 64 + 1) * kWarpgroup, smem, stream>>>(
      map_a, map_b, c, m, k, n, bk, stages, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one GEMM on `stream`: C (m x n) = A (m x k) . B (k x ldb)[:, :n].
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a tile
// shape that was not compiled, a depth that is not a multiple of 64, row
// strides TMA cannot take, or a ring larger than shared memory).
int repro_gemm(const void* a, const void* b, void* c, int m, int k, int n, int ldb, int bm,
               int bk, int bn, int stages, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 != 0 || ldb % 8 != 0 || ldb < n || bk <= 0 ||
      bk % kSwizzleK != 0 || bk > 256 || stages < 1 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_GEMM_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch<BM_, BN_>(a, b, c, m, k, n, ldb, bk, stages, out_f32, s);
  REPRO_GEMM_CASE(64, 32)
  REPRO_GEMM_CASE(64, 64)
  REPRO_GEMM_CASE(64, 128)
  REPRO_GEMM_CASE(64, 256)
  REPRO_GEMM_CASE(128, 32)
  REPRO_GEMM_CASE(128, 64)
  REPRO_GEMM_CASE(128, 128)
  REPRO_GEMM_CASE(128, 256)
#undef REPRO_GEMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
