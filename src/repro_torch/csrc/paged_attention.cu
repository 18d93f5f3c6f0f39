// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_attention_pallas (src/repro/kernels/
// paged_attention.py:176, body _paged_kernel :136).
//
// Shapes: q (B, Hq, Dh) bf16; pages_k/v (P, ps, Hkv, Dh) bf16;
// page_table (B, W) int32; pos (B,) int32; out (B, Hq, Dh) bf16.
// A row attends its logical prefix k < min(pos + 1, W * ps).
//
// What bounds it on this card.  Decode attention reads each attended K/V
// row once and does 4 * G operations per element read (G = Hq / Hkv query
// heads share one KV head), so it is bound by the bytes of the attended
// cache.  The design: one block per (row, kv-head), so the G query heads
// of a group read their shared K/V rows once; the block reads its own page
// ids from the table (clipped to [0, P-1], the TPU kernel's scalar
// prefetch) and walks only the positions its row attends — masked
// positions contribute exactly 0 in the reference, so skipping them moves
// fewer bytes without changing the result.  Scores are warp dot products
// over Dh; the softmax is online, in fp32, chunk by chunk (the reference
// streams a page per grid step), with the reference's constants: masked
// scores -1e30, l clamped at 1e-30, p rounded to the value dtype before
// the p·V product.  Split-K over pages is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;   // positions scored per online-softmax update
constexpr int kMaxG = 8;     // query heads per KV head
constexpr int kMaxDpt = 2;   // head-dim elements per thread (Dh <= 256)

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pages_k,
                       const __nv_bfloat16* __restrict__ pages_v,
                       const int* __restrict__ table, const int* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out, int P, int ps, int Hkv,
                       int Dh, int W, int G, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // (G, Dh) query heads of this group, fp32
  float* ss = smem + G * Dh;      // (G, kChunk) scores of the current chunk

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long s_cache = static_cast<long long>(W) * ps;
  const long long lim = static_cast<long long>(pos[b]) + 1;
  const int limit = static_cast<int>(lim < s_cache ? lim : s_cache);

  for (int i = threadIdx.x; i < G * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i % Dh;
    qs[i] = __bfloat162float(q[(static_cast<size_t>(b) * Hq + h * G + g) * Dh + d]);
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][kMaxDpt];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -1e30f;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[g][j] = 0.0f;
  }
  __syncthreads();

  auto row = [&](const __nv_bfloat16* arena, int idx) {
    int page = table[static_cast<size_t>(b) * W + idx / ps];
    page = page < 0 ? 0 : (page > P - 1 ? P - 1 : page);
    return arena + ((static_cast<size_t>(page) * ps + idx % ps) * Hkv + h) * Dh;
  };

  for (int c0 = 0; c0 < limit; c0 += kChunk) {
    const int n = min(kChunk, limit - c0);

    // Scores: one warp per position, lanes split the head dim.
    for (int t = warp; t < n; t += kWarps) {
      const __nv_bfloat16* krow = row(pages_k, c0 + t);
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.0f;
      for (int d = lane; d < Dh; d += 32) {
        const float kv = __bfloat162float(krow[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] = fmaf(qs[g * Dh + d], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float v = part[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) ss[g * kChunk + t] = v * scale;
      }
    }
    __syncthreads();

    // Online softmax: every thread keeps the same (m, l) per head,
    // computed from the same scores in the same order.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float mc = -1e30f;
      for (int t = 0; t < n; ++t) mc = fmaxf(mc, ss[g * kChunk + t]);
      const float m_new = fmaxf(m[g], mc);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < kMaxDpt; ++j) acc[g][j] *= alpha;
    }
    for (int t = 0; t < n; ++t) {
      const __nv_bfloat16* vrow = row(pages_v, c0 + t);
      float vv[kMaxDpt];
#pragma unroll
      for (int j = 0; j < kMaxDpt; ++j) {
        const int d = threadIdx.x + j * kThreads;
        vv[j] = d < Dh ? __bfloat162float(vrow[d]) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = expf(ss[g * kChunk + t] - m[g]);
        l[g] += p;
        const float pb = __bfloat162float(__float2bfloat16(p));
#pragma unroll
        for (int j = 0; j < kMaxDpt; ++j) acc[g][j] = fmaf(pb, vv[j], acc[g][j]);
      }
    }
    __syncthreads();  // the next chunk overwrites the scores
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    const float denom = fmaxf(l[g], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d < Dh) {
        out[(static_cast<size_t>(b) * Hq + h * G + g) * Dh + d] =
            __float2bfloat16(acc[g][j] / denom);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch one paged decode-attention call on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for unsupported shapes).
int repro_paged_attention(const void* q, const void* pages_k, const void* pages_v,
                          const void* table, const void* pos, void* out, int B,
                          int Hq, int Hkv, int Dh, int P, int ps, int W,
                          float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || Dh > kThreads * kMaxDpt ||
      P <= 0 || ps <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = Hq / Hkv;
  const size_t smem = static_cast<size_t>(G) * (Dh + kChunk) * sizeof(float);
  dim3 grid(B, Hkv);
  paged_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pages_k),
      static_cast<const __nv_bfloat16*>(pages_v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), P, ps, Hkv, Dh, W,
      G, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
