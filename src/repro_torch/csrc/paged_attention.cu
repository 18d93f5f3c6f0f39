// Paged single-token GQA decode attention for Hopper (sm_90a), the cache
// walk split across blocks (flash-decoding) and combined deterministically.
//
// Replaces the TPU kernel paged_attention_pallas (src/repro/kernels/
// paged_attention.py:176, body _paged_kernel :136).
//
// Shapes: q (B, Hq, Dh) bf16; pages_k/v (P, ps, Hkv, Dh) bf16; page_table
// (B, W) int32; pos (B,) int32; out (B, Hq, Dh) bf16; all contiguous and
// 16-byte aligned, Dh % 8 == 0, Dh <= 256, G = Hq / Hkv <= 8.  A row attends
// its logical prefix k < min(pos + 1, W * ps); page ids clip to [0, P-1].
//
// What it computes is what _paged_kernel computes: fp32 scores from the
// bf16 q . k products times `scale`; masked scores at the finite -1e30; an
// fp32 running max m, sum l and accumulator acc, with p = exp(s - m_new)
// rounded to bf16 before the p . V product and l summing the unrounded p;
// the output acc / max(l, 1e-30) rounded to bf16.  (Scores are kept in
// base 2, scaled by log2 e, so each exponential is one exp2.)
//
// What bounds it on this card.  Each attended position costs one K row and
// one V row of Dh bf16 (4 Dh bytes) and 4 G Dh operations for the G query
// heads that share the KV head: G operations a byte, at most 8 here and 1-5
// in the port's models, far below the ~295 at which the tensor cores would
// be the limit.  So the kernel is bound by the bytes of the attended cache
// (12 rows of 4,096 tokens at internlm2-1.8b's 8 KV heads of 128: 201 MB,
// 60 us at 3.35 TB/s), and the design keeps those bytes in flight across
// the whole card while spending as few instructions as it can on each:
//   * split the walk (grid (B, Hkv, n_split)).  Each block walks a
//     contiguous run of `split_pages` pages of one row for one KV head;
//     the host's split_plan (kernels/paged_attention.py) picks the run from
//     the shapes alone, never from pos, so a short cache (the engine's
//     24-token slot) runs one split and a long one several blocks an SM.
//     A block whose run lies wholly past its row's limit writes an empty
//     partial (m = -1e30, l = 0, acc = 0) and exits;
//   * one block serves all G query heads of its KV head, so each K/V row is
//     read once for the group;
//   * the block reads its run's page ids once into shared memory, clipped.
//     Its four warps walk the run in tiles of kT = 16 positions, warp w
//     taking the w-th tile of every four, as four independent online
//     softmaxes: no block-wide barrier in the walk.  A warp's lanes move
//     its tiles' K and V rows as 16-byte cp.async copies (zero-filled past
//     the run or the head dim) into the warp's own ring of kStages tiles;
//     the next tile's copies are in flight while a tile is multiplied;
//   * both products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//     sums in registers).  On the CUDA cores, a 16-byte slice of K costs 8 G
//     fused multiply-adds, its conversions and a shuffle tree per head for
//     the scores, and as much again for p . V: at G = 5 that held a first
//     version of this kernel to a quarter of the bound however its
//     occupancy was tuned, with the memory far from busy.  Here the G heads
//     are the rows of one 16-row tile (rows past G are zero): S = Q . K^T
//     takes Q from registers and K through ldmatrix; the online softmax
//     runs on S's fragments (a head's 16 scores lie in the 4 lanes of a
//     quad: max and sum by two shuffles, each exp once); and O^T = V^T . P^T
//     takes P^T straight from S's fragments, rounded to bf16 (the C layout
//     of S's two 8-position tiles is the B layout of one 16-position step),
//     and V^T through ldmatrix.trans.  A tile of 16 positions costs a warp
//     about 24 mma and 16 ldmatrix at Dh 128 whatever G is;
//   * a deterministic combine.  At the end of the run the warps' (m, l,
//     acc) merge in warp order through shared memory.  With one split the
//     block divides and writes the output itself (one launch).  With more,
//     each block writes its partial (acc[G][Dh], m, l; m in base 2) in fp32
//     to a workspace the wrapper allocates, and paged_combine_kernel merges
//     them per (row, KV head) in split order: out = sum_s 2^(m_s - M) acc_s /
//     max(sum_s 2^(m_s - M) l_s, 1e-30).  No atomics anywhere, so two calls
//     on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;       // positions in a warp's tile
constexpr int kStages = 2;   // a warp's ring, in tiles
constexpr int kMaxG = 8;
constexpr int kMaxSplitPages = 1024;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pages_k;
  const __nv_bfloat16* pages_v;
  const int* table;
  const int* pos;
  __nv_bfloat16* out;
  float* ws;  // (B, Hkv, n_split, G * (Dh + 2)): acc[G][Dh], then (m, l)[G]
  int P, ps, ps_shift, Hkv, G, Dh, W, split_pages, n_split;
  float scale;
};

// Shared memory for a head dim padded to kD: each warp's ring of kStages
// x {K, V} x [kT][kD] bf16 (swizzled 16-byte chunks), then the run's page
// ids.  After the walk the ring's bytes hold the warps' sums.
__host__ __device__ constexpr size_t ring_bytes(int kD) {
  return static_cast<size_t>(kWarps) * kStages * 2 * kT * kD * 2;
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of rows kD wide.
template <int kD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kD * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // Fills the 16 bytes with zeros when !valid (src-size 0 reads nothing).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
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

template <int kD>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  constexpr int kDK = kD / 16;        // 16-wide steps over the head dim
  constexpr int kChunks = kD / 8;     // 16-byte chunks in a row
  constexpr int kRowsPerPass = 32 / kChunks;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.G, Dh = a.Dh;
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = a.Hkv * G;
  const int g = lane / 4;   // this lane's head (row of S) and column pair of O^T
  const int qd = lane % 4;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                        warp * kStages * 2 * kT * kD * 2;
  int* pids = reinterpret_cast<int*>(smem + ring_bytes(kD));

  const long long s_cache = static_cast<long long>(a.W) * a.ps;
  const long long lim = static_cast<long long>(a.pos[b]) + 1;
  const int limit = static_cast<int>(lim < s_cache ? lim : s_cache);
  const int page0 = split * a.split_pages;
  const int s0 = page0 * a.ps;
  const int span = min(min(a.W, page0 + a.split_pages) * a.ps, limit) - s0;  // positions to walk
  float* part = a.n_split == 1 ? nullptr
                               : a.ws + (static_cast<size_t>(b * a.Hkv + h) * a.n_split + split) *
                                            G * (Dh + 2);

  if (span <= 0) {  // the run lies wholly past the row's limit
    if (a.n_split == 1) {
      for (int i = tid; i < G * Dh; i += kThreads)
        a.out[(static_cast<size_t>(b) * Hq + h * G) * Dh + i] = __float2bfloat16(0.0f);
    } else {
      for (int i = tid; i < G * Dh; i += kThreads) part[i] = 0.0f;
      if (tid < G) {
        part[G * Dh + 2 * tid] = kNegInf;
        part[G * Dh + 2 * tid + 1] = 0.0f;
      }
    }
    return;
  }

  for (int i = tid; i < (span + a.ps - 1) / a.ps; i += kThreads) {
    const int pg = a.table[static_cast<size_t>(b) * a.W + page0 + i];
    pids[i] = pg < 0 ? 0 : (pg > a.P - 1 ? a.P - 1 : pg);
  }

  // Q's A fragments (rows g and g + 8 of each 16-wide step; rows past G,
  // and every row g + 8, are zero), straight from global memory.
  uint32_t qf[kDK][2];
  {
    const __nv_bfloat16* qrow = a.q + (static_cast<size_t>(b) * Hq + h * G + g) * Dh;
#pragma unroll
    for (int c = 0; c < kDK; ++c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * c + 8 * half + 2 * qd;
        qf[c][half] = g < G && col < Dh ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u;
      }
    }
  }
  float o[kDK][4];  // O^T: dims 16 t + g (and + 8) x heads 2 qd, 2 qd + 1
#pragma unroll
  for (int t = 0; t < kDK; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;
  float m = kNegInf, l = 0.0f;  // of head g, in base 2
  const float scale_log2 = a.scale * kLog2e;
  __syncthreads();  // the page ids

  const int first = warp * kT;  // this warp's tiles start here in every block tile
  const int n_tiles = span > first ? (span - first + kWarps * kT - 1) / (kWarps * kT) : 0;
  const size_t row_stride = static_cast<size_t>(a.Hkv) * Dh;
  const int c_lane = lane % kChunks;
  const int r_lane = lane / kChunks;
  auto issue = [&](int i) {
    const int base = i * kWarps * kT + first;
    const uint32_t ks = ring + (i % kStages) * 2 * kT * kD * 2;
    const uint32_t vs = ks + kT * kD * 2;
#pragma unroll
    for (int k = 0; k < kT / kRowsPerPass; ++k) {
      const int r = k * kRowsPerPass + r_lane;
      const int rel = base + r;
      const bool valid = rel < span && c_lane * 8 < Dh;
      size_t off = 0;
      if (valid) {
        const int pi = a.ps_shift >= 0 ? rel >> a.ps_shift : rel / a.ps;
        off = (static_cast<size_t>(pids[pi]) * a.ps + (rel - pi * a.ps)) * row_stride +
              static_cast<size_t>(h) * Dh + c_lane * 8;
      }
      cp_async16(ks + swz<kD>(r, c_lane), a.pages_k + off, valid);
      cp_async16(vs + swz<kD>(r, c_lane), a.pages_v + off, valid);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) issue(st);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane -> (position within the 16, chunk offset),
  // the same for K's B fragments and V^T's A fragments.
  const int ld_row = (lane % 8) + 8 * (lane / 16);
  const int ld_chunk = (lane / 8) % 2;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // every lane's copies of tile i have landed; tile i - 1 is consumed
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    const int base = i * kWarps * kT + first;
    const uint32_t ks = ring + (i % kStages) * 2 * kT * kD * 2;
    const uint32_t vs = ks + kT * kD * 2;

    // S = Q . K^T: heads x 16 positions, two 8-position tiles.
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int c = 0; c < kDK; ++c) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(ks + swz<kD>(ld_row, 2 * c + ld_chunk), b0, b1, b2, b3);
      mma(s[0], qf[c][0], 0u, qf[c][1], 0u, b0, b1);
      mma(s[1], qf[c][0], 0u, qf[c][1], 0u, b2, b3);
    }

    // Online softmax of head g over the tile: its 16 scores lie in the
    // quad's 4 lanes (positions 2 qd, 2 qd + 1, 8 + 2 qd, 9 + 2 qd).
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = base + 8 * n + 2 * qd + e < span;
        s[n][e] = valid ? s[n][e] * scale_log2 : kNegInf;
        mx = fmaxf(mx, s[n][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - m_new);
        sum += s[n][e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = alpha * l + sum;
    m = m_new;

    // O^T = alpha O^T + V^T . P^T; O^T's columns are heads 2 qd and 2 qd + 1,
    // whose alphas live in lanes 8 qd and 8 qd + 4.
    const float alpha0 = __shfl_sync(0xffffffffu, alpha, 8 * qd);
    const float alpha1 = __shfl_sync(0xffffffffu, alpha, 8 * qd + 4);
    const uint32_t p0 = pack_bf16(s[0][0], s[0][1]);  // P^T's B fragment: positions 2 qd, 2 qd + 1
    const uint32_t p1 = pack_bf16(s[1][0], s[1][1]);  // and 8 + 2 qd, 9 + 2 qd, of head g
#pragma unroll
    for (int t = 0; t < kDK; ++t) {
      o[t][0] *= alpha0;
      o[t][1] *= alpha1;
      o[t][2] *= alpha0;
      o[t][3] *= alpha1;
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4_trans(vs + swz<kD>(ld_row, 2 * t + ld_chunk), a0, a1, a2, a3);
      mma(o[t], a0, a1, a2, a3, p0, p1);
    }
  }
  cp_async_wait<0>();

  // The warps merge in order through shared memory (over the rings, once
  // every warp is done with its own).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (kWarps, G, Dh)
  float* wml = red + kWarps * G * Dh;           // (kWarps, G, 2)
#pragma unroll
  for (int t = 0; t < kDK; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * qd + (e & 1);
      const int dim = 16 * t + g + 8 * (e >> 1);
      if (head < G && dim < Dh) red[(warp * G + head) * Dh + dim] = o[t][e];
    }
  }
  if (qd == 0 && g < G) {
    wml[(warp * G + g) * 2] = m;
    wml[(warp * G + g) * 2 + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += kThreads) {
    const int hg = i / Dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wml[(w * G + hg) * 2]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(wml[(w * G + hg) * 2] - M);
      L += c * wml[(w * G + hg) * 2 + 1];
      A += c * red[w * G * Dh + i];
    }
    if (a.n_split == 1) {
      a.out[(static_cast<size_t>(b) * Hq + h * G) * Dh + i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      part[i] = A;
      if (i % Dh == 0) {
        part[G * Dh + 2 * hg] = M;
        part[G * Dh + 2 * hg + 1] = L;
      }
    }
  }
}

// Merge the splits' partials of one (row, KV head), in split order.
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int Hkv,
                     int G, int Dh, int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t stride = static_cast<size_t>(G) * (Dh + 2);
  const float* base = ws + static_cast<size_t>(b * Hkv + h) * n_split * stride;
  for (int i = threadIdx.x; i < G * Dh; i += kThreads) {
    const int g = i / Dh;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, base[s * stride + G * Dh + 2 * g]);
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = base + s * stride;
      const float c = exp2f(p[G * Dh + 2 * g] - M);
      L += c * p[G * Dh + 2 * g + 1];
      A += c * p[i];
    }
    out[(static_cast<size_t>(b) * Hkv * G + h * G) * Dh + i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

template <int kD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = ring_bytes(kD) + static_cast<size_t>(a.split_pages) * sizeof(int);
  static bool opted_in = false;  // per instantiation: raise the limit once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring_bytes(kD) + kMaxSplitPages * sizeof(int)));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    opted_in = true;
  }
  dim3 grid(B, a.Hkv, a.n_split);
  paged_split_kernel<kD><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  paged_combine_kernel<<<dim3(B, a.Hkv), kThreads, 0, stream>>>(a.ws, a.out, a.Hkv, a.G, a.Dh,
                                                                  a.n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one paged decode-attention call on `stream`: the split walk and,
// when n_split > 1, the combine over `ws` (B * Hkv * n_split * G * (Dh + 2)
// floats).  Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for shapes or a plan the kernel does not take).
int repro_paged_attention(const void* q, const void* pages_k, const void* pages_v,
                          const void* table, const void* pos, void* out, void* ws, int B,
                          int Hq, int Hkv, int Dh, int P, int ps, int W, int split_pages,
                          int n_split, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 || Hq / Hkv > kMaxG ||
      Dh <= 0 || Dh % 8 != 0 || Dh > 256 || P <= 0 || ps <= 0 || W <= 0 || split_pages <= 0 ||
      split_pages > kMaxSplitPages || n_split != (W + split_pages - 1) / split_pages ||
      n_split > 65535 || (n_split > 1 && ws == nullptr) ||
      static_cast<long long>(W) * ps >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ps_shift = -1;
  if ((ps & (ps - 1)) == 0) {
    ps_shift = 0;
    while ((1 << ps_shift) < ps) ++ps_shift;
  }
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pages_k),
         static_cast<const __nv_bfloat16*>(pages_v), static_cast<const int*>(table),
         static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
         P, ps, ps_shift, Hkv, Hq / Hkv, Dh, W, split_pages, n_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 64) return launch<64>(a, B, s);
  if (Dh <= 128) return launch<128>(a, B, s);
  return launch<256>(a, B, s);
}

}  // extern "C"
