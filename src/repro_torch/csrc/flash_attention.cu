// Blocked (flash) attention for Hopper (sm_90a): full-sequence GQA
// attention over (B, S, H, D) bf16 tensors, online softmax in fp32.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py:80, pl.pallas_call :137, body _flash_kernel :38).
//
// Shapes: q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) with Hq % Hkv == 0; out
// (B, Sq, Hq, D); all bf16, contiguous, 16-byte aligned, D % 8 == 0 and
// D <= 256.  Queries are the suffix of the keys: query i sits at key
// position i + Sk - Sq.  Key j is visible to query i when j < Sk, and
// (causal) j <= i + Sk - Sq, and (window > 0) i + Sk - Sq - j < window.
//
// What it computes is what _flash_kernel computes: fp32 scores from the
// bf16 q . k products times `scale`; masked scores at the finite -1e30
// (never -inf: exp(m_prev - m_new) of two -inf values is NaN); per row an
// fp32 running max m, sum l and accumulator acc over the key blocks, with
// p = exp(s - m_new) rounded to bf16 before the p . V product, l summing
// the unrounded p; the output acc / max(l, 1e-30) rounded to bf16.
//
// What bounds it on this card.  At the forward's shape (B 2, S 2048, 24
// query heads over 8 KV heads of 128) a causal call does 4 B Hq D S(S+1)/2
// = 51.6 GFLOP on 67 MB of q, k, v and out: about 770 operations per byte,
// so it is bound by arithmetic, by the tensor cores' rate in the bound.
// This first kernel runs the two products on the CUDA cores (fp32 FMA,
// 67 TFLOP/s at most), so it cannot come near that bound; mma/wgmma
// fragments, TMA and a producer warp are later work.  What the design does
// about the arithmetic it has: it never computes a key block that lies
// wholly past the causal diagonal or wholly before the window (about half
// the blocks of a causal call), each thread keeps a 4 x 4 tile of scores
// and a 4 x D/16 tile of the output in registers, so every value read from
// shared memory feeds 4 FMAs, and the shared-memory rows are padded so
// that no read conflicts on a bank.
//
// Grid: one block per (q-block of 64 rows, query head, batch row), the
// heaviest causal q-blocks first.  The TPU grid's sequential K dimension
// becomes a loop inside the block: Q is staged once, then each 64-key
// block of K and V (of KV head h / (Hq / Hkv): GQA is read in place, not
// repeated) is staged, scored, folded into (m, l, acc) and dropped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx over columns, ty over rows
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged block
constexpr int kRows = kBQ / 16;  // query rows a thread owns (ty + 16 i)
constexpr int kCols = kBK / 16;  // score columns a thread owns (tx + 16 j)
constexpr float kNegInf = -1e30f;

// Shared-memory layout, in bytes, for head dim D:
//   Qs float [kBQ][D + 1]   queries in fp32 (padded: two rows per warp)
//   Ks bf16  [kBK][D + 2]   keys (padded: 16 rows per warp read at once)
//   Vs bf16  [kBK][D]       values
//   Ps float [kBQ][kBK + 1] probabilities, rounded to bf16
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return static_cast<size_t>(kBQ) * (D + 1) * 4 + static_cast<size_t>(kBK) * (D + 2) * 2 +
         static_cast<size_t>(kBK) * D * 2 + static_cast<size_t>(kBQ) * (kBK + 1) * 4;
}

// Stage rows [r0, r0 + n) of a (rows x D) slice with row stride `ld`
// elements; rows at or past `limit` are zero.  Eight elements (16 bytes)
// per load.
template <typename Store>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, size_t ld, int r0, int n,
                                           int limit, int D, Store store) {
  const int per_row = D / 8;
  for (int c = threadIdx.x; c < n * per_row; c += kThreads) {
    const int r = c / per_row;
    const int d = (c % per_row) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) {
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * ld + d);
    }
    store(r, d, raw);
  }
}

template <int kMaxD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                       float scale) {
  constexpr int kDCols = kMaxD / 16;  // output columns a thread owns (tx + 16 j)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = D + 1;
  const int ldk = D + 2;
  float* Qs = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(Qs + kBQ * ldq);
  __nv_bfloat16* Vs = Ks + kBK * ldk;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * D);

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const int q_offset = Sk - Sq;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* q_base = q + (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const __nv_bfloat16* k_base = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* v_base = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  stage_rows(q_base, q_ld, q0, kBQ, Sq, D, [&](int r, int d, uint4 raw) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[r * ldq + d + i] = __bfloat162float(e[i]);
  });

  // The key blocks this q-block can see; the others are wholly masked for
  // every row, and the TPU kernel's visits to them change nothing (see
  // kernels/flash_attention.py).
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kb_end = (Sk + kBK - 1) / kBK;
  if (causal) kb_end = min(kb_end, (q_offset + q_last) / kBK + 1);
  int kb_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    if (lo > 0) kb_begin = lo / kBK;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous block's K, V and P are consumed
    stage_rows(k_base, kv_ld, k0, kBK, Sk, D, [&](int r, int d, uint4 raw) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<__nv_bfloat162*>(Ks + r * ldk + d + 2 * i) = e[i];
    });
    stage_rows(v_base, kv_ld, k0, kBK, Sk, D, [&](int r, int d, uint4 raw) {
      *reinterpret_cast<uint4*>(Vs + r * D + d) = raw;
    });
    __syncthreads();

    // Scores s = (q . k) * scale for rows ty + 16 i, keys tx + 16 j.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = __bfloat162float(Ks[(tx + 16 * j) * ldk + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then fold the block into each row's (m, l, acc).  The 16
    // threads of a row are the lanes of one half-warp.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < Sk;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = __bfloat162float(__float2bfloat16(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P . V for rows ty + 16 i, columns tx + 16 j.
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          const float vv = __bfloat162float(Vs[kk * D + col]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  __nv_bfloat16* o_base = out + (static_cast<size_t>(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int col = tx + 16 * j;
      if (col < D) o_base[static_cast<size_t>(row) * q_ld + col] = __float2bfloat16(acc[i][j] / denom);
    }
  }
}

template <int kMaxD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int Hq, int Hkv, int D, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<kMaxD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<kMaxD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv,
      D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one attention call on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
// `window` <= 0 means no window; `causal` needs Sq <= Sk, so that every
// query sees at least one key.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D % 8 != 0 ||
      D > 256 || Hq > 65535 || B > 65535 || (causal && Sq > Sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
  if (D <= 128) return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
  return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
}

}  // extern "C"
