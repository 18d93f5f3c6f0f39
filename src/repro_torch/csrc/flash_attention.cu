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
// so it is bound by arithmetic, at the tensor cores' rate.  The design
// puts both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 sums in registers) and keeps every intermediate out of device
// memory:
//   * each of the block's 4 warps owns 16 query rows; their Q is loaded
//     once with ldmatrix into the A fragments of S = Q . K^T (for D <= 128;
//     at D = 256 the fragments are re-read from shared memory, so that the
//     128 output accumulators fit the registers);
//   * K and V come in blocks of 64 keys through a two-stage cp.async ring:
//     the next block is in flight while this one is multiplied.  Rows are
//     stored in 16-byte chunks XOR-swizzled by row, so the ldmatrix reads
//     of 8 rows hit 8 different banks;
//   * the scale, the mask and the online softmax run on the S fragments in
//     registers: row max and row sum over the 4 lanes of a quad, by
//     shuffles; scores in base 2, so that each exponential is one exp2; the
//     mask tested only on blocks that straddle the diagonal, the window or
//     the end of the keys.  p is rounded to bf16 straight into the A
//     fragments of O += P . V (the m16n8k16 C layout of two adjacent 8-key
//     tiles is the A layout of one 16-key step), so P never touches shared
//     memory;
//   * key blocks wholly past the causal diagonal or wholly before the
//     window are skipped, for the block and, within a block, per warp.
// Warp-specialised wgmma with TMA (FlashAttention-3) is later work.
//
// Grid: one block per (q-block of 64 rows, query head, batch row), the
// heaviest causal q-blocks first.  The TPU grid's sequential K dimension
// becomes the loop over key blocks inside the block; K and V are read from
// KV head h / (Hq / Hkv) in place (GQA costs no repeated K/V).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per staged block
constexpr float kNegInf = -1e30f;

// Shared memory for a head dim padded to kD: Q [kBQ][kD], then K and V in
// two stages each [kBK][kD], all bf16 with swizzled 16-byte chunks.
__host__ __device__ constexpr size_t smem_bytes(int kD) {
  return static_cast<size_t>(kBQ + 4 * kBK) * kD * 2;
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of rows kD wide.
template <int kD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kD * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // Fills the 16 bytes with zeros when !valid (src-size 0 reads nothing).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [r0, r0 + rows) of a (limit x D) slice with row stride `ld`
// elements into a swizzled tile kD wide; rows past `limit` and columns
// past D are zero.
template <int kD>
__device__ __forceinline__ void stage_rows(uint32_t tile, const __nv_bfloat16* src, size_t ld,
                                           int r0, int rows, int limit, int D) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r0 + r < limit && c * 8 < D;
    const __nv_bfloat16* g = valid ? src + static_cast<size_t>(r0 + r) * ld + c * 8 : src;
    cp_async16(tile + swz<kD>(r, c), g, valid);
  }
}

// The forward's body.  kLse (the training forward) also writes each row's
// natural log-sum-exp of its scaled scores, fp32, into lse (B, Hq, Sq
// rounded up to kBQ), 0 for the rows past Sq; the inference kernel is the
// kLse = false instantiation and takes no lse.
template <int kD, bool kLse>
__device__ __forceinline__ void attention_forward(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
    float scale) {
  constexpr bool kQInRegs = kD <= 128;
  constexpr int kDK = kD / 16;   // 16-wide steps over the head dim
  constexpr int kDN = kD / 8;    // 8-wide output tiles
  constexpr int kSN = kBK / 8;   // 8-key score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_tile = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t k_tile = q_tile + kBQ * kD * 2;       // [2][kBK][kD]
  const uint32_t v_tile = k_tile + 2 * kBK * kD * 2;   // [2][kBK][kD]
  constexpr uint32_t kv_stage = kBK * kD * 2;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const int q_offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* q_base = q + (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const __nv_bfloat16* k_base = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* v_base = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

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

  // Q, then the first K/V block: one cp.async group.
  stage_rows<kD>(q_tile, q_base, q_ld, q0, kBQ, Sq, D);
  stage_rows<kD>(k_tile, k_base, kv_ld, kb_begin * kBK, kBK, Sk, D);
  stage_rows<kD>(v_tile, v_base, kv_ld, kb_begin * kBK, kBK, Sk, D);
  cp_async_commit();

  // This thread's rows of the warp's 16: g and g + 8 (fragment layout).
  const int g = lane / 4;
  const int qd = lane % 4;
  const int row_lo = 16 * warp;                      // first row of the warp in the q-block
  const int pos0 = q_offset + q0 + row_lo + g;       // key position of row g
  const int warp_first = q_offset + q0 + row_lo;     // of the warp's rows
  const int warp_last = q_offset + min(q0 + row_lo + 15, Sq - 1);

  uint32_t qf[kQInRegs ? kDK : 1][4];
  float o[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  // ldmatrix row addresses: lane -> (row within the 16, chunk offset).
  const int a_row = row_lo + (lane % 8) + 8 * ((lane / 8) % 2);  // Q: A fragments
  const int a_chunk = lane / 16;
  const int k_row = (lane % 8) + 8 * (lane / 16);                // K: B fragments of 2 tiles
  const int k_chunk = (lane / 8) % 2;
  const int v_row = (lane % 8) + 8 * ((lane / 8) % 2);           // V: transposed B fragments
  const int v_chunk = lane / 16;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int stage = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) {
      const uint32_t next = (stage ^ 1) * kv_stage;
      stage_rows<kD>(k_tile + next, k_base, kv_ld, (kb + 1) * kBK, kBK, Sk, D);
      stage_rows<kD>(v_tile + next, v_base, kv_ld, (kb + 1) * kBK, kBK, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (kb == kb_begin) {
#pragma unroll
        for (int c = 0; c < kDK; ++c) {
          ldmatrix_x4(q_tile + swz<kD>(a_row, 2 * c + a_chunk), qf[c][0], qf[c][1], qf[c][2],
                      qf[c][3]);
        }
      }
    }

    const int k0 = kb * kBK;
    // A warp whose rows see none of this block's keys skips it: past the
    // diagonal it would add p = 0 at alpha = 1; before the window what it
    // adds is wiped by alpha = 0 at the row's first visible key.
    const bool visible = !(causal && warp_last < k0) &&
                         !(window > 0 && warp_first - (k0 + kBK - 1) >= window) &&
                         row_lo + q0 < Sq;
    if (visible) {
      const uint32_t ks = k_tile + stage * kv_stage;
      const uint32_t vs = v_tile + stage * kv_stage;

      // S = Q . K^T: 16 rows x 64 keys a warp, fp32.
      float s[kSN][4];
#pragma unroll
      for (int j = 0; j < kSN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int c = 0; c < kDK; ++c) {
        uint32_t a0, a1, a2, a3;
        if constexpr (kQInRegs) {
          a0 = qf[c][0]; a1 = qf[c][1]; a2 = qf[c][2]; a3 = qf[c][3];
        } else {
          ldmatrix_x4(q_tile + swz<kD>(a_row, 2 * c + a_chunk), a0, a1, a2, a3);
        }
#pragma unroll
        for (int j = 0; j < kSN; j += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(ks + swz<kD>(8 * j + k_row, 2 * c + k_chunk), b0, b1, b2, b3);
          mma(s[j], a0, a1, a2, a3, b0, b1);
          mma(s[j + 1], a0, a1, a2, a3, b2, b3);
        }
      }

      // Scale and mask, then fold the block into (m, l, o) row by row.  The
      // scores are kept in base 2 (scaled by log2 e), so each exponential is
      // one exp2; masks are tested only where the block straddles a bound.
      const bool whole = k0 + kBK <= Sk && !(causal && warp_first < k0 + kBK - 1) &&
                         !(window > 0 && warp_last - k0 >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = pos0 + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * i + e];
            if (whole) {
              x *= scale_log2;
            } else {
              const int kj = k0 + 8 * j + 2 * qd + e;
              bool ok = kj < Sk;
              if (causal) ok = ok && qi >= kj;
              if (window > 0) ok = ok && (qi - kj) < window;
              x = ok ? x * scale_log2 : kNegInf;
            }
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * i + e];
            x = exp2f(x - m_new);
            sum += x;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = alpha * l[i] + sum;
#pragma unroll
        for (int j = 0; j < kDN; ++j) {
          o[j][2 * i] *= alpha;
          o[j][2 * i + 1] *= alpha;
        }
      }

      // O += P . V, p rounded to bf16 into the A fragments of each 16-key step.
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const uint32_t a0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
        const uint32_t a1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
        const uint32_t a2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
        for (int t = 0; t < kDN; t += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(vs + swz<kD>(16 * c + v_row, t + v_chunk), b0, b1, b2, b3);
          mma(o[t], a0, a1, a2, a3, b0, b1);
          mma(o[t + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }

  __nv_bfloat16* o_base = out + (static_cast<size_t>(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_lo + g + 8 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < kDN; ++t) {
      const int col = 8 * t + 2 * qd;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(o_base + static_cast<size_t>(row) * q_ld + col) =
            __floats2bfloat162_rn(o[t][2 * i] / denom, o[t][2 * i + 1] / denom);
      }
    }
  }
  if constexpr (kLse) {
    // lse = ln(sum exp(scale s)) = (m + log2 l) ln 2, m kept in base 2.
    if (qd == 0) {
      float* lse_row = lse + (static_cast<size_t>(b) * Hq + h) * gridDim.x * kBQ;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + row_lo + g + 8 * i;
        lse_row[row] = row < Sq ? (m[i] + log2f(l[i])) * 0.6931471805599453f : 0.0f;
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 128 ? 2 : 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                       float scale) {
  attention_forward<kD, false>(q, k, v, out, nullptr, Sq, Sk, Hq, Hkv, D, causal, window, scale);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_lse_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int D,
                           int causal, int window, float scale) {
  attention_forward<kD, true>(q, k, v, out, lse, Sq, Sk, Hq, Hkv, D, causal, window, scale);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int Hq, int Hkv, int D, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kD);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv,
      D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_lse(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
               int Sk, int Hq, int Hkv, int D, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(kD);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_lse_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_lse_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, Hq, Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward: dQ, dK and dV of the forward's attention, for D <= 128.
//
// Replaces no TPU kernel: the reference trains through its portable
// chunked path, and so did the port, in fp32 PyTorch.  With o the bf16
// output, lse the training forward's per-row log-sum-exp and dO the
// output's gradient, per (batch row, query head):
//   P  = exp(scale q.k - lse) on the visible keys, 0 elsewhere (fp32);
//   dV = sum over the group's query heads of P^T . dO   (P rounded to bf16);
//   dP = dO . V^T (fp32), Di = rowsum(dO o o) (fp32);
//   dS = P o (dP - Di) scale, fp32, rounded to bf16 only as an operand:
//   dQ = dS . K,  dK = sum over the group's query heads of dS^T . Q.
// Every product is mma.sync m16n8k16 on bf16 operands with fp32 sums.
//
// What bounds it: as the forward, arithmetic.  At a training layer
// (B 4, S 2,048, 16 / 8 heads of 128, causal) the two kernels make seven
// products of 4 B Hq D S(S+1)/2 / 2 = 34.4 GFLOP each (S and dP are
// recomputed by both), 240 GFLOP, on about 100 MB.  Two kernels, so that
// no sum crosses blocks: no atomics, and two calls give the same bits.
//   * flash_attention_bwd_dq: one block per (q-block of 64, query head,
//     batch row), the forward's grid and key-block walk; it first writes
//     Di for its rows (read by the second kernel, launched after it on
//     the same stream), then, per key block from the cp.async ring,
//     recomputes S and P, forms dP and dS in registers and adds dS . K
//     into the warp's 16 x D fp32 dQ.
//   * flash_attention_bwd_dkdv: one block per (key block of 64, KV head,
//     batch row), each warp 16 keys holding their dK and dV (2 x 16 x D
//     fp32) in registers; it walks the group's query heads and, for each,
//     the q-blocks that see its keys (causal and window skipping, as
//     kernels/flash_attention.query_blocks), Q, dO, lse and Di staged
//     through a two-stage cp.async ring, 32 queries at a time so that the
//     score and dP fragments fit beside the accumulators.  P^T and dS^T go
//     from the C fragments straight into the A fragments of the next
//     product, as the forward's P does; K and V stay in shared memory.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// Either backward kernel: two resident 64-row tiles, two two-stage ones,
// and four rows of 64 fp32 values.
__host__ __device__ constexpr size_t bwd_smem_bytes(int kD) {
  return static_cast<size_t>(6 * kBK) * kD * 2 + 4 * kBQ * sizeof(float);
}

// Stage 64 fp32 values (16 chunks) with threads [first, first + 16).
__device__ __forceinline__ void stage_f32x64(uint32_t dst, const float* src, int first) {
  const int t = static_cast<int>(threadIdx.x) - first;
  if (t >= 0 && t < 16) cp_async16(dst + 16 * t, src + 4 * t, true);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                       int Hq, int Hkv, int D, int causal, int window, float scale) {
  constexpr int kDK = kD / 16;
  constexpr int kDN = kD / 8;
  constexpr int kSN = kBK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_tile = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t do_tile = q_tile + kBQ * kD * 2;
  const uint32_t k_tile = do_tile + kBQ * kD * 2;      // [2][kBK][kD]
  const uint32_t v_tile = k_tile + 2 * kBK * kD * 2;   // [2][kBK][kD]
  float* delta_s = reinterpret_cast<float*>(smem + static_cast<size_t>(6 * kBK) * kD * 2);
  constexpr uint32_t kv_stage = kBK * kD * 2;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const int q_offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale_log2 = scale * kLog2e;
  const size_t row_ld = static_cast<size_t>(gridDim.x) * kBQ;  // lse / delta rows

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t q_head = (static_cast<size_t>(b) * Sq * Hq + h) * D;
  const __nv_bfloat16* q_base = q + q_head;
  const __nv_bfloat16* do_base = dout + q_head;
  const __nv_bfloat16* o_base = o + q_head;
  const __nv_bfloat16* k_base = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* v_base = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const float* lse_row = lse + (static_cast<size_t>(b) * Hq + h) * row_ld + q0;
  float* delta_row = delta + (static_cast<size_t>(b) * Hq + h) * row_ld + q0;

  // The forward's key blocks for this q-block.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kb_end = (Sk + kBK - 1) / kBK;
  if (causal) kb_end = min(kb_end, (q_offset + q_last) / kBK + 1);
  int kb_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    if (lo > 0) kb_begin = lo / kBK;
  }

  stage_rows<kD>(q_tile, q_base, q_ld, q0, kBQ, Sq, D);
  stage_rows<kD>(do_tile, do_base, q_ld, q0, kBQ, Sq, D);
  if (kb_begin < kb_end) {
    stage_rows<kD>(k_tile, k_base, kv_ld, kb_begin * kBK, kBK, Sk, D);
    stage_rows<kD>(v_tile, v_base, kv_ld, kb_begin * kBK, kBK, Sk, D);
  }
  cp_async_commit();

  // Di = rowsum(dO o O) in fp32, two threads a row (0 past Sq), while the
  // first tiles are in flight.
  {
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    float acc = 0.0f;
    if (q0 + r < Sq) {
      const __nv_bfloat16* orow = o_base + static_cast<size_t>(q0 + r) * q_ld;
      const __nv_bfloat16* drow = do_base + static_cast<size_t>(q0 + r) * q_ld;
      for (int c = half; c * 8 < D; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(o2[e]);
          const float2 fd = __bfloat1622float2(d2[e]);
          acc = fmaf(fo.x, fd.x, acc);
          acc = fmaf(fo.y, fd.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      delta_row[r] = acc;
    }
  }
  __syncthreads();

  const int g = lane / 4;
  const int qd = lane % 4;
  const int row_lo = 16 * warp;
  const int pos0 = q_offset + q0 + row_lo + g;
  const int warp_first = q_offset + q0 + row_lo;
  const int warp_last = q_offset + min(q0 + row_lo + 15, Sq - 1);
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_row[row_lo + g + 8 * i] * kLog2e;
    di[i] = delta_s[row_lo + g + 8 * i];
  }
  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  const int a_row = row_lo + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_chunk = lane / 16;
  const int k_row = (lane % 8) + 8 * (lane / 16);
  const int k_chunk = (lane / 8) % 2;
  const int t_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int t_chunk = lane / 16;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int stage = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) {
      const uint32_t next = (stage ^ 1) * kv_stage;
      stage_rows<kD>(k_tile + next, k_base, kv_ld, (kb + 1) * kBK, kBK, Sk, D);
      stage_rows<kD>(v_tile + next, v_base, kv_ld, (kb + 1) * kBK, kBK, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = kb * kBK;
    const bool visible = !(causal && warp_last < k0) &&
                         !(window > 0 && warp_first - (k0 + kBK - 1) >= window) &&
                         row_lo + q0 < Sq;
    if (visible) {
      const uint32_t ks = k_tile + stage * kv_stage;
      const uint32_t vs = v_tile + stage * kv_stage;
      // S = Q . K^T and dP = dO . V^T: 16 rows x 64 keys a warp, fp32.
      float s[kSN][4], dp[kSN][4];
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kDK; ++c) {
        uint32_t a0, a1, a2, a3, d0, d1, d2, d3;
        ldmatrix_x4(q_tile + swz<kD>(a_row, 2 * c + a_chunk), a0, a1, a2, a3);
        ldmatrix_x4(do_tile + swz<kD>(a_row, 2 * c + a_chunk), d0, d1, d2, d3);
#pragma unroll
        for (int j = 0; j < kSN; j += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(ks + swz<kD>(8 * j + k_row, 2 * c + k_chunk), b0, b1, b2, b3);
          mma(s[j], a0, a1, a2, a3, b0, b1);
          mma(s[j + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4(vs + swz<kD>(8 * j + k_row, 2 * c + k_chunk), b0, b1, b2, b3);
          mma(dp[j], d0, d1, d2, d3, b0, b1);
          mma(dp[j + 1], d0, d1, d2, d3, b2, b3);
        }
      }
      // P from the saved lse, then dS = P (dP - Di) scale, into s.
      const bool whole = k0 + kBK <= Sk && !(causal && warp_first < k0 + kBK - 1) &&
                         !(window > 0 && warp_last - k0 >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = pos0 + 8 * i;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool ok = true;
            if (!whole) {
              const int kj = k0 + 8 * j + 2 * qd + e;
              ok = kj < Sk;
              if (causal) ok = ok && qi >= kj;
              if (window > 0) ok = ok && (qi - kj) < window;
            }
            const float p = exp2f(s[j][2 * i + e] * scale_log2 - lse2[i]);
            s[j][2 * i + e] = ok ? p * (dp[j][2 * i + e] - di[i]) * scale : 0.0f;
          }
        }
      }
      // dQ += dS . K, dS rounded to bf16 into the A fragments.
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const uint32_t a0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
        const uint32_t a1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
        const uint32_t a2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
        for (int t = 0; t < kDN; t += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(ks + swz<kD>(16 * c + t_row, t + t_chunk), b0, b1, b2, b3);
          mma(acc[t], a0, a1, a2, a3, b0, b1);
          mma(acc[t + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dq_base = dq + q_head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_lo + g + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int t = 0; t < kDN; ++t) {
      const int col = 8 * t + 2 * qd;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dq_base + static_cast<size_t>(row) * q_ld + col) =
            __floats2bfloat162_rn(acc[t][2 * i], acc[t][2 * i + 1]);
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int D,
                         int causal, int window, float scale) {
  constexpr int kDK = kD / 16;
  constexpr int kDN = kD / 8;
  constexpr int kQH = 32;          // queries a warp takes at once
  constexpr int kSN = kQH / 8;     // their 8-query score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_tile = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t v_tile = k_tile + kBK * kD * 2;
  const uint32_t q_tile = v_tile + kBK * kD * 2;        // [2][kBQ][kD]
  const uint32_t do_tile = q_tile + 2 * kBQ * kD * 2;   // [2][kBQ][kD]
  const uint32_t lse_tile = do_tile + 2 * kBQ * kD * 2; // [2][kBQ] fp32
  const uint32_t di_tile = lse_tile + 2 * kBQ * 4;      // [2][kBQ] fp32
  const float* lse_s = reinterpret_cast<const float*>(smem + static_cast<size_t>(6 * kBK) * kD * 2);
  const float* di_s = lse_s + 2 * kBQ;
  constexpr uint32_t q_stage = kBQ * kD * 2;

  const int kb = blockIdx.x;  // the first key blocks see the most queries: first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kb * kBK;
  const int q_offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale_log2 = scale * kLog2e;
  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const size_t row_ld = static_cast<size_t>(n_qb) * kBQ;

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t kv_head = (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  // The q-blocks that see this key block (kernels/flash_attention.query_blocks).
  int qb_begin = 0;
  int qb_end = n_qb;
  if (causal && k0 - q_offset > 0) qb_begin = (k0 - q_offset) / kBQ;
  if (window > 0) {
    const int hi = window + min(k0 + kBK, Sk) - 2 - q_offset;  // the last query its last key serves
    qb_end = hi < 0 ? 0 : min(n_qb, hi / kBQ + 1);
  }
  const int n_q = max(qb_end - qb_begin, 0);
  const int n_items = group * n_q;  // (query head of the group, q-block), head outer

  const int g = lane / 4;
  const int qd = lane % 4;
  const int kw0 = k0 + 16 * warp;   // the warp's first key
  const int kw1 = kw0 + 15;
  float dk_acc[kDN][4], dv_acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.0f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.0f;
  }

  const int a_row = 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2);  // K, V: A fragments
  const int a_chunk = lane / 16;
  const int b_row = (lane % 8) + 8 * (lane / 16);                   // Q, dO: B fragments
  const int b_chunk = (lane / 8) % 2;
  const int t_row = (lane % 8) + 8 * ((lane / 8) % 2);              // Q, dO: transposed B
  const int t_chunk = lane / 16;

  auto stage_item = [&](int it, int st) {
    const int h = hk * group + it / n_q;
    const int q0 = (qb_begin + it % n_q) * kBQ;
    const size_t q_head = (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const size_t row = (static_cast<size_t>(b) * Hq + h) * row_ld + q0;
    stage_rows<kD>(q_tile + st * q_stage, q + q_head, q_ld, q0, kBQ, Sq, D);
    stage_rows<kD>(do_tile + st * q_stage, dout + q_head, q_ld, q0, kBQ, Sq, D);
    stage_f32x64(lse_tile + st * kBQ * 4, lse + row, 0);
    stage_f32x64(di_tile + st * kBQ * 4, delta + row, 32);
  };

  if (n_items > 0) {
    stage_rows<kD>(k_tile, k + kv_head, kv_ld, k0, kBK, Sk, D);
    stage_rows<kD>(v_tile, v + kv_head, kv_ld, k0, kBK, Sk, D);
    stage_item(0, 0);
    cp_async_commit();
  }

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) {
      stage_item(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qb_begin + it % n_q) * kBQ;
    const uint32_t qs = q_tile + st * q_stage;
    const uint32_t dos = do_tile + st * q_stage;
    const float* ls = lse_s + st * kBQ;
    const float* ds = di_s + st * kBQ;

#pragma unroll
    for (int half = 0; half < kBQ / kQH; ++half) {
      const int qa = q0 + kQH * half;              // first query of the half
      const int pa = q_offset + qa;                // its key position
      const int pb = q_offset + min(qa + kQH - 1, Sq - 1);
      // A warp whose keys no query of the half sees skips it (p = 0).
      const bool visible = qa < Sq && kw0 < Sk && !(causal && pb < kw0) &&
                           !(window > 0 && pa - kw1 >= window);
      if (!visible) continue;
      // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x 32 queries a warp.
      float s[kSN][4], dp[kSN][4];
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kDK; ++c) {
        uint32_t a0, a1, a2, a3, w0, w1, w2, w3;
        ldmatrix_x4(k_tile + swz<kD>(a_row, 2 * c + a_chunk), a0, a1, a2, a3);
        ldmatrix_x4(v_tile + swz<kD>(a_row, 2 * c + a_chunk), w0, w1, w2, w3);
#pragma unroll
        for (int j = 0; j < kSN; j += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(qs + swz<kD>(kQH * half + 8 * j + b_row, 2 * c + b_chunk), b0, b1, b2, b3);
          mma(s[j], a0, a1, a2, a3, b0, b1);
          mma(s[j + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4(dos + swz<kD>(kQH * half + 8 * j + b_row, 2 * c + b_chunk), b0, b1, b2, b3);
          mma(dp[j], w0, w1, w2, w3, b0, b1);
          mma(dp[j + 1], w0, w1, w2, w3, b2, b3);
        }
      }
      // P^T into s, dS^T = P^T (dP^T - Di) scale into dp.
      const bool whole = qa + kQH <= Sq && !(causal && pa < kw1) &&
                         !(window > 0 && pb - kw0 >= window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = kw0 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < kSN; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kQH * half + 8 * j + 2 * qd + e;
            bool ok = true;
            if (!whole) {
              const int qi = q0 + col;
              const int pos = q_offset + qi;
              ok = qi < Sq;
              if (causal) ok = ok && pos >= kj;
              if (window > 0) ok = ok && (pos - kj) < window;
            }
            const float p = ok ? exp2f(s[j][2 * i + e] * scale_log2 - ls[col] * kLog2e) : 0.0f;
            s[j][2 * i + e] = p;
            dp[j][2 * i + e] = ok ? p * (dp[j][2 * i + e] - ds[col]) * scale : 0.0f;
          }
        }
      }
      // dV += P^T . dO and dK += dS^T . Q, the 32 queries as two 16-deep steps.
#pragma unroll
      for (int c = 0; c < kQH / 16; ++c) {
        const uint32_t p0 = pack_bf16(s[2 * c][0], s[2 * c][1]);
        const uint32_t p1 = pack_bf16(s[2 * c][2], s[2 * c][3]);
        const uint32_t p2 = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        const uint32_t p3 = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
        const uint32_t e0 = pack_bf16(dp[2 * c][0], dp[2 * c][1]);
        const uint32_t e1 = pack_bf16(dp[2 * c][2], dp[2 * c][3]);
        const uint32_t e2 = pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]);
        const uint32_t e3 = pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3]);
        const int r = kQH * half + 16 * c + t_row;
#pragma unroll
        for (int t = 0; t < kDN; t += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(dos + swz<kD>(r, t + t_chunk), b0, b1, b2, b3);
          mma(dv_acc[t], p0, p1, p2, p3, b0, b1);
          mma(dv_acc[t + 1], p0, p1, p2, p3, b2, b3);
          ldmatrix_x4_trans(qs + swz<kD>(r, t + t_chunk), b0, b1, b2, b3);
          mma(dk_acc[t], e0, e1, e2, e3, b0, b1);
          mma(dk_acc[t + 1], e0, e1, e2, e3, b2, b3);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kw0 + g + 8 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int t = 0; t < kDN; ++t) {
      const int col = 8 * t + 2 * qd;
      if (col < D) {
        const size_t at = kv_head + static_cast<size_t>(row) * kv_ld + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[t][2 * i], dk_acc[t][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[t][2 * i], dv_acc[t][2 * i + 1]);
      }
    }
  }
}

template <int kD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Sk, int Hq, int Hkv, int D, int causal, int window, float scale,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int smem = static_cast<int>(bwd_smem_bytes(kD));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ first: it writes the Di that the dK/dV kernel reads.
  dim3 grid_q((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_bwd_dq<kD><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(o), static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf*>(dq), Sq, Sk, Hq, Hkv, D, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_k((Sk + kBK - 1) / kBK, Hkv, B);
  flash_attention_bwd_dkdv<kD><<<grid_k, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, Hq,
      Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

static bool valid_shape(int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int d_max) {
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && Hq % Hkv == 0 && D > 0 && D % 8 == 0 &&
         D <= d_max && Hq <= 65535 && B <= 65535 && !(causal && Sq > Sk);
}

// Launch one attention call on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
// `window` <= 0 means no window; `causal` needs Sq <= Sk, so that every
// query sees at least one key.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                          float scale, void* stream) {
  if (!valid_shape(B, Sq, Sk, Hq, Hkv, D, causal, 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
  if (D <= 128) return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
  return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
}

// The training forward: the same output, and lse (B, Hq, Sq rounded up to
// 64) fp32, for D <= 128.
int repro_flash_attention_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                              int window, float scale, void* stream) {
  if (!valid_shape(B, Sq, Sk, Hq, Hkv, D, causal, 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    return launch_lse<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
  }
  return launch_lse<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s);
}

// The backward: dq (as q), dk, dv (as k) from the forward's o, its lse and
// dout (as q); delta (as lse) is scratch that receives Di.  Two launches on
// `stream`, dQ's then dK/dV's.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq, void* dk,
                              void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                              int window, float scale, void* stream) {
  if (!valid_shape(B, Sq, Sk, Hq, Hkv, D, causal, 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                          causal, window, scale, s);
  }
  return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                         causal, window, scale, s);
}

}  // extern "C"
