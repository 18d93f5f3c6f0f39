// The Mamba2 chunked SSD scan for Hopper (sm_90a), forward and backward.
//
// Replaces no TPU kernel: the reference scans in jnp operations
// (src/repro/models/ssm.py, _ssd_chunked), and the port ran the same
// operations in fp32 PyTorch (models/ssm.py, _ssd_chunked).  The algorithm
// is the SSD block decomposition of arXiv:2405.21060 (sections 6-7), in the
// stages of mamba_ssm's ssd_combined.py.
//
// Shapes (16-byte aligned): x (B, S, H, P) bf16; dt (B, S, H) fp32, after
// the softplus; A (H) fp32, negative, all three contiguous; Bm, Cm (B, S,
// G, N) bf16 with rows ld_bc elements apart (a multiple of 8: the model's B
// and C are slices of one projection's rows, read in place), head h reading
// group h / (H / G); the entering state (B, H, N, P) fp32 or null; P = 64,
// N = 64 or 128, a chunk Q of 64, 128 or 256 dividing S.  A
// chunk's positions t, s run over [0, Q); l_t is the running sum of A dt_u
// over u <= t in the chunk, L[t, s] = exp(l_t - l_s) for s <= t (masked
// before the exponential), and
//   y_t = sum_s (C_t . B_s) L[t, s] dt_s x_s + exp(l_t) C_t . h_c,
//   h_{c+1} = exp(l_{Q-1}) h_c + sum_s exp(l_{Q-1} - l_s) dt_s B_s (x) x_s.
//
// Arithmetic.  Everything the configuration keeps in fp32 is fp32: A dt,
// its running sum, every exponential, the states (in registers and in
// memory), every accumulator, the gradients of dt and A.  Every product runs
// on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums).  x, B,
// C and the output's gradient are bf16 values and enter as they are; an fp32
// operand (the decay-weighted scores and x, the states and their gradients,
// exp(l) C, the gradient of C . B^T) enters as a bf16 high part and the bf16
// rounding of the rest: two products, about 16 bits of the value.
//
// What bounds it.  At 4 x 2,048 tokens, 64 heads of 64, N 128, one group,
// Q 256, a forward is 26 GFLOP on 139 MB: 42 us at 3.35 TB/s, 26 us at
// 989 TFLOP/s.  The fp32 PyTorch scan took 7.5 ms: (B, nc, Q, Q, H) fp32
// intermediates, B and C copied to every head, fp32 products off the tensor
// cores.  Here no (Q, Q) block per head touches device memory: C . B^T is
// computed once per group (8 MB) and each head's scores are made from it in
// registers, masked, weighted and split straight into the A fragments of
// the score-times-x product.  The states live in fp32 registers across the
// chunks of a (row, head); the entering states are written once, as the
// bf16 high and low planes their consumers multiply, so that every stage
// stages them with cp.async.  Every tile comes into shared memory through
// cp.async, most through two-stage rings (the next tile in flight while
// this one is multiplied); rows are padded by 16 bytes, so that the
// ldmatrix reads of 8 rows hit 8 different banks.  Measured on an H100 at
// the cell's layer (PERF.md, the kernel table's row 5): a forward 0.45 ms,
// a backward 1.1 ms, against 6.4 and 17 ms for the PyTorch scan.
//
// Forward, three launches:
//   ssd_cb          C . B^T per (chunk, group), the 64 x 64 tiles on and
//                   below the diagonal, fp32;
//   ssd_state_fwd   one block per (row, head) walking the chunks: dt and l
//                   (written by head, for the other stages), the entering
//                   state written, the state decayed and the chunk's state
//                   added on the tensor cores;
//   ssd_chunk_scan  one block per (64-row tile, chunk, head, row): exp(l_t)
//                   C . h_c, then the masked scores times x.
// Backward, six launches, no atomics (every sum in a fixed order, so the
// gradients are the same bits call after call):
//   ssd_bwd_state   the chunks walked backwards per (row, head): the state
//                   gradients, each chunk's decay gradient;
//   ssd_bwd_dcb     dCB = sum over the group's heads of (dy . x^T) o L o dt;
//   ssd_bwd_dx      per (64-row tile, chunk, head): dx, and each position's
//                   dt and dl terms;
//   ssd_bwd_dbdc    dB and dC: per tile, split and group, the sum over up to
//                   8 heads, and one more split for the dCB products;
//   ssd_bwd_dt      per (chunk, head, row): dl summed backwards into ddt;
//   ssd_bwd_reduce  the splits summed in order into dB, dC (bf16); dA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;             // positions per tile
constexpr int kP = 64;             // head dim
constexpr int kPad = 8;            // bf16 padding of a shared row (bank-conflict-free ldmatrix)
constexpr int kLdP = kP + kPad;    // a shared row of head-dim width
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as a bf16 pair (high) and the bf16 pair of what is left.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Fragments from shared tiles of bf16 rows `ld` elements apart.  A (16 x 16
// at m0, k0) from a [m][k] tile, or from a [k][m] tile (ldA_T); B of two
// 8-wide tiles (n0 and n0 + 8, k0 .. k0 + 16; b[0], b[1] the first) from a
// [n][k] tile, or from a [k][n] tile (ldB_T).
__device__ __forceinline__ void ldA(uint32_t tile, int ld, int m0, int k0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int m = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k = k0 + (lane >> 4) * 8;
  ldmatrix_x4(tile + (m * ld + k) * 2, a);
}

__device__ __forceinline__ void ldA_T(uint32_t tile, int ld, int m0, int k0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + (lane & 7) + (lane >> 4) * 8;
  const int m = m0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(tile + (k * ld + m) * 2, a);
}

__device__ __forceinline__ void ldB(uint32_t tile, int ld, int n0, int k0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int k = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(tile + (n * ld + k) * 2, b);
}

__device__ __forceinline__ void ldB_T(uint32_t tile, int ld, int n0, int k0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(tile + (k * ld + n) * 2, b);
}

// A fragments (high, low) of one 16-wide k step from fp32 values in the
// accumulator layout of its two 8-wide tiles v0, v1.
__device__ __forceinline__ void split_frag(const float (&v0)[4], const float (&v1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(v0[0], v0[1], hi[0], lo[0]);
  split2(v0[2], v0[3], hi[1], lo[1]);
  split2(v1[0], v1[1], hi[2], lo[2]);
  split2(v1[2], v1[3], hi[3], lo[3]);
}

// cp.async `rows` bf16 rows of `cols` (a multiple of 8) from src (rows
// src_ld elements apart) into a shared tile of rows `ld` apart.
__device__ __forceinline__ void stage_rows(uint32_t tile, int ld, const bf16* src, size_t src_ld,
                                           int rows, int cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    cp_async16(tile + (r * ld + c) * 2, src + r * src_ld + c);
  }
}

__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four bf16 values scaled by s in fp32, split into shared high and low rows.
__device__ __forceinline__ void store_scaled_split(bf16* hi, bf16* lo, float4 v, float s) {
  uint2 h, l;
  split2(v.x * s, v.y * s, h.x, l.x);
  split2(v.z * s, v.w * s, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// The inclusive running sum of v[0 .. n) in place, by one warp: each lane
// sums n / 32 consecutive values, then the lanes' totals are scanned.
__device__ __forceinline__ void warp_cumsum(float* v, int n) {
  const int lane = threadIdx.x & 31;
  const int per = n / 32;
  float run = 0.0f;
  for (int e = 0; e < per; ++e) {
    run += v[lane * per + e];
    v[lane * per + e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  for (int e = 0; e < per; ++e) v[lane * per + e] += excl;
}

// The sum of v over the block, in a fixed order, returned to every thread;
// `red` holds one float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < warps; ++w) total += red[w];
  return total;
}

// A (kN x kP) fp32 matrix held in accumulators (this thread: rows n0, n0 +
// 8; columns 8 jj + q2, + 1) stored as its bf16 high plane and, `plane`
// elements on, its bf16 low plane.
__device__ __forceinline__ void store_planes(bf16* dst, size_t plane, const float (&acc)[8][4],
                                             int n0, int q2) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t hi, lo;
      split2(acc[jj][2 * hr], acc[jj][2 * hr + 1], hi, lo);
      const size_t o = static_cast<size_t>(n0 + 8 * hr) * kP + 8 * jj + q2;
      *reinterpret_cast<uint32_t*>(dst + o) = hi;
      *reinterpret_cast<uint32_t*>(dst + plane + o) = lo;
    }
  }
}

// The tile pair (i, j), j <= i, of a lower-triangular index.
__device__ __forceinline__ void tile_pair(int p, int& i, int& j) {
  i = 0;
  while (p > i) {
    p -= i + 1;
    ++i;
  }
  j = p;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// C . B^T of the tile pair (i, j) of chunk c, group g: cb (B, nc, G, Q, Q).
// Grid (pairs, nc * G, B), 4 warps, 16 rows each.
template <int kN>
__global__ void __launch_bounds__(128) ssd_cb(const bf16* __restrict__ Bm,
                                              const bf16* __restrict__ Cm, float* __restrict__ cb,
                                              int S, int G, int Q, int ld_bc) {
  constexpr int kLd = kN + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t c_tile = smem_u32(smem);
  const uint32_t b_tile = c_tile + kT * kLd * 2;
  int i, j;
  tile_pair(blockIdx.x, i, j);
  const int c = blockIdx.y / G, g = blockIdx.y % G, b = blockIdx.z;
  const int nc = S / Q;
  const size_t row_ld = ld_bc;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  stage_rows(c_tile, kLd, Cm + (row0 + i * kT) * row_ld + g * kN, row_ld, kT, kN);
  stage_rows(b_tile, kLd, Bm + (row0 + j * kT) * row_ld + g * kN, row_ld, kT, kN);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][4] = {};
#pragma unroll
  for (int k = 0; k < kN; k += 16) {
    uint32_t a[4];
    ldA(c_tile, kLd, 16 * warp, k, a);
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      uint32_t bb[4];
      ldB(b_tile, kLd, 8 * jj, k, bb);
      mma(acc[jj], a, bb[0], bb[1]);
      mma(acc[jj + 1], a, bb[2], bb[3]);
    }
  }
  float* out = cb + ((static_cast<size_t>(b) * nc + c) * G + g) * Q * Q +
               static_cast<size_t>(i * kT + 16 * warp + (lane >> 2)) * Q + j * kT + 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<float2*>(out + 8 * jj) = make_float2(acc[jj][0], acc[jj][1]);
    *reinterpret_cast<float2*>(out + 8 * Q + 8 * jj) = make_float2(acc[jj][2], acc[jj][3]);
  }
}

// One (row, head) walking its chunks.  Writes dt and l by head (B, H, S),
// each chunk's entering state as bf16 high and low planes (B, nc, H, 2, N,
// P), the operand its consumers multiply, and the final state in fp32.  The
// state (N x P) lives in the accumulators: warp w holds rows n of 16w .. 16w
// + 16.  The B and x rows of each 64-position tile come through a two-stage
// cp.async ring (the next tile, across chunks too, in flight while this one
// is multiplied); a chunk's dt is loaded during the chunk before.  Grid (H,
// B), N / 16 warps.
template <int kN>
__global__ void __launch_bounds__(2 * kN) ssd_state_fwd(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const float* __restrict__ init, float* __restrict__ l_out,
    float* __restrict__ dth_out, bf16* __restrict__ states, float* __restrict__ final_state,
    int S, int H, int G, int Q, int ld_bc) {
  constexpr int kLdN = kN + kPad;
  constexpr int kThreads = 2 * kN;
  constexpr int kRing = (kT * kLdN + kT * kLdP) * 2;   // a stage: B rows, then x rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xw_hi = reinterpret_cast<bf16*>(smem + 2 * kRing);   // [kT][kLdP]: w_s x_s
  bf16* xw_lo = xw_hi + kT * kLdP;
  float* l_s = reinterpret_cast<float*>(xw_lo + kT * kLdP);  // [Q]
  float* dt_s = l_s + Q;                                     // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int nc = S / Q, n_t = Q / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const float a_h = A[h];
  const size_t hs = (static_cast<size_t>(b) * H + h) * S;   // (b, h) in (B, H, S)
  const size_t nstate = static_cast<size_t>(kN) * kP;
  const int n0 = 16 * warp + r;                              // this thread's rows n0, n0 + 8
  const size_t bld = ld_bc, xld = static_cast<size_t>(H) * kP;

  auto stage = [&](int idx) {   // tile idx of the walk: chunk idx / n_t, tile idx % n_t
    const uint32_t st = smem_u32(smem + (idx & 1) * kRing);
    const size_t row = static_cast<size_t>(b) * S + static_cast<size_t>(idx) * kT;
    stage_rows(st, kLdN, Bm + row * bld + g * kN, bld, kT, kN);
    stage_rows(st + kT * kLdN * 2, kLdP, x + row * xld + static_cast<size_t>(h) * kP, xld, kT, kP);
  };
  constexpr int kPer = 256 / kThreads;   // dt values a thread holds (Q <= 256)
  float dreg[kPer];
  auto load_dt = [&](int c) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int s = threadIdx.x + e * kThreads;
      if (s < Q) dreg[e] = dt[(static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q + s) * H + h];
    }
  };

  float acc[8][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (init != nullptr) {
      const float* src = init + (static_cast<size_t>(b) * H + h) * nstate + 8 * jj + q2;
      const float2 u = *reinterpret_cast<const float2*>(src + n0 * kP);
      const float2 v = *reinterpret_cast<const float2*>(src + (n0 + 8) * kP);
      acc[jj][0] = u.x; acc[jj][1] = u.y; acc[jj][2] = v.x; acc[jj][3] = v.y;
    } else {
      acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.0f;
    }
  }
  stage(0);
  cp_async_commit();
  load_dt(0);

  for (int c = 0; c < nc; ++c) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int s = threadIdx.x + e * kThreads;
      if (s < Q) {
        dt_s[s] = dreg[e];
        l_s[s] = a_h * dreg[e];
      }
    }
    __syncthreads();
    if (warp == 0) warp_cumsum(l_s, Q);
    if (c + 1 < nc) load_dt(c + 1);
    __syncthreads();
    for (int s = threadIdx.x; s < Q; s += blockDim.x) {
      l_out[hs + c * Q + s] = l_s[s];
      dth_out[hs + c * Q + s] = dt_s[s];
    }
    const float last = l_s[Q - 1];
    const float decay = expf(last);
    store_planes(states + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * nstate, nstate, acc, n0,
                 q2);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] *= decay;
    }
    for (int t = 0; t < n_t; ++t) {
      const int idx = c * n_t + t;
      if (idx + 1 < nc * n_t) {
        stage(idx + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* x_raw = reinterpret_cast<const bf16*>(smem + (idx & 1) * kRing) + kT * kLdN;
      for (int i = threadIdx.x; i < kT * kP / 4; i += blockDim.x) {
        const int rr = i / (kP / 4);
        const int cc = (i % (kP / 4)) * 4;
        const int sp = t * kT + rr;
        const float w = expf(last - l_s[sp]) * dt_s[sp];
        store_scaled_split(xw_hi + rr * kLdP + cc, xw_lo + rr * kLdP + cc,
                           load_bf16x4(x_raw + rr * kLdP + cc), w);
      }
      __syncthreads();
      const uint32_t b_tile = smem_u32(smem + (idx & 1) * kRing);
#pragma unroll
      for (int k = 0; k < kT; k += 16) {
        uint32_t a[4];
        ldA_T(b_tile, kLdN, 16 * warp, k, a);
#pragma unroll
        for (int jj = 0; jj < 8; jj += 2) {
          uint32_t bh[4], bl[4];
          ldB_T(smem_u32(xw_hi), kLdP, 8 * jj, k, bh);
          ldB_T(smem_u32(xw_lo), kLdP, 8 * jj, k, bl);
          mma(acc[jj], a, bh[0], bh[1]);
          mma(acc[jj + 1], a, bh[2], bh[3]);
          mma(acc[jj], a, bl[0], bl[1]);
          mma(acc[jj + 1], a, bl[2], bl[3]);
        }
      }
      __syncthreads();
    }
  }
  float* fin = final_state + (static_cast<size_t>(b) * H + h) * nstate + q2;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<float2*>(fin + n0 * kP + 8 * jj) = make_float2(acc[jj][0], acc[jj][1]);
    *reinterpret_cast<float2*>(fin + (n0 + 8) * kP + 8 * jj) = make_float2(acc[jj][2], acc[jj][3]);
  }
}

// One 64-row tile i of chunk c, head h, row b: y = exp(l_t) C_t . h_c +
// sum_{s <= t} (C_t . B_s) L[t, s] dt_s x_s.  The scores' product walks the
// s tiles 0 .. i, x's rows of each through a two-stage cp.async ring; C's
// rows and the entering state's planes arrive meanwhile, for the state's
// product last.  Grid (Q / 64, nc * H, B), 4 warps, 16 rows each.
template <int kN>
__global__ void __launch_bounds__(128) ssd_chunk_scan(
    const bf16* __restrict__ x, const bf16* __restrict__ Cm, const float* __restrict__ cb,
    const float* __restrict__ l, const float* __restrict__ dth, const bf16* __restrict__ states,
    bf16* __restrict__ y, int S, int H, int G, int Q, int ld_bc) {
  constexpr int kLdN = kN + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* c_tile = reinterpret_cast<bf16*>(smem);   // [kT][kLdN]
  bf16* s_hi = c_tile + kT * kLdN;                // [kN][kLdP]
  bf16* s_lo = s_hi + kN * kLdP;
  bf16* x_ring = s_lo + kN * kLdP;                // [2][kT][kLdP]
  float* l_s = reinterpret_cast<float*>(x_ring + 2 * kT * kLdP);
  float* dt_s = l_s + Q;

  const int i = blockIdx.x;
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = S / Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t hs = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q;
  const size_t xld = static_cast<size_t>(H) * kP;
  const int rows = (i + 1) * kT;   // the positions this tile sees

  auto stage_x = [&](int j) {
    stage_rows(smem_u32(x_ring + (j & 1) * kT * kLdP), kLdP,
               x + (row0 + j * kT) * xld + static_cast<size_t>(h) * kP, xld, kT, kP);
  };
  stage_x(0);
  for (int e = threadIdx.x; e < rows / 2; e += blockDim.x) {   // l and dt, 16 bytes a copy
    const bool is_l = e < rows / 4;
    const int q = (is_l ? e : e - rows / 4) * 4;
    cp_async16(smem_u32((is_l ? l_s : dt_s) + q), (is_l ? l : dth) + hs + q);
  }
  cp_async_commit();
  stage_rows(smem_u32(c_tile), kLdN, Cm + (row0 + i * kT) * ld_bc + g * kN, ld_bc, kT, kN);
  const bf16* planes = states + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * kN * kP;
  stage_rows(smem_u32(s_hi), kLdP, planes, kP, kN, kP);
  stage_rows(smem_u32(s_lo), kLdP, planes + kN * kP, kP, kN, kP);
  cp_async_commit();

  const int t0 = i * kT + 16 * warp + r;   // this thread's rows t0, t0 + 8 (in the chunk)
  float acc[8][4] = {};
  const float* cbt = cb + ((static_cast<size_t>(b) * nc + c) * G + g) * Q * Q;
  // The warp's k steps run to its last row (every later score is masked);
  // each step's C . B^T values are loaded one step ahead.
  const int s_end = i * kT + 16 * warp + 16;
  float2 nxt[2][2];
  auto load_cb = [&](int sb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        nxt[half][hr] = *reinterpret_cast<const float2*>(
            cbt + static_cast<size_t>(t0 + 8 * hr) * Q + sb + 8 * half + q2);
      }
    }
  };
  load_cb(0);
  float lt[2];
  for (int j = 0; j <= i; ++j) {
    // Pending groups, oldest first: x tile 0 with l and dt; C and the
    // planes; then one x tile a step.  Wait for tile j's.
    if (j < i) {
      stage_x(j + 1);
      cp_async_commit();
      if (j == 0) cp_async_wait<2>(); else cp_async_wait<1>();
    } else {
      if (j == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      lt[0] = l_s[t0];
      lt[1] = l_s[t0 + 8];
    }
    const uint32_t xs = smem_u32(x_ring + (j & 1) * kT * kLdP);
    const int sb_end = min(s_end, (j + 1) * kT);
    for (int sb = j * kT; sb < sb_end; sb += 16) {
      float2 cur[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        cur[half][0] = nxt[half][0];
        cur[half][1] = nxt[half][1];
      }
      if (sb + 16 < s_end) load_cb(sb + 16);
      float v[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = sb + 8 * half + q2;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + 8 * hr;
          v[half][2 * hr] = t >= s ? cur[half][hr].x * expf(lt[hr] - l_s[s]) * dt_s[s] : 0.0f;
          v[half][2 * hr + 1] =
              t >= s + 1 ? cur[half][hr].y * expf(lt[hr] - l_s[s + 1]) * dt_s[s + 1] : 0.0f;
        }
      }
      uint32_t ah[4], al[4];
      split_frag(v[0], v[1], ah, al);
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        uint32_t bx[4];
        ldB_T(xs, kLdP, 8 * jj, sb - j * kT, bx);
        mma(acc[jj], ah, bx[0], bx[1]);
        mma(acc[jj + 1], ah, bx[2], bx[3]);
        mma(acc[jj], al, bx[0], bx[1]);
        mma(acc[jj + 1], al, bx[2], bx[3]);
      }
    }
    __syncthreads();   // tile j's ring stage is free for tile j + 2
  }

  // The entering state's part, exp(l_t) C_t . h_c, added to the scores'.
  cp_async_wait<0>();
  __syncthreads();
  float inter[8][4] = {};
#pragma unroll
  for (int k = 0; k < kN; k += 16) {
    uint32_t a[4];
    ldA(smem_u32(c_tile), kLdN, 16 * warp, k, a);
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      uint32_t bh[4], bl[4];
      ldB_T(smem_u32(s_hi), kLdP, 8 * jj, k, bh);
      ldB_T(smem_u32(s_lo), kLdP, 8 * jj, k, bl);
      mma(inter[jj], a, bh[0], bh[1]);
      mma(inter[jj + 1], a, bh[2], bh[3]);
      mma(inter[jj], a, bl[0], bl[1]);
      mma(inter[jj + 1], a, bl[2], bl[3]);
    }
  }
  const float e0 = expf(lt[0]), e1 = expf(lt[1]);
  bf16* out = y + ((row0 + t0) * H + h) * kP + q2;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
        __floats2bfloat162_rn(e0 * inter[jj][0] + acc[jj][0], e0 * inter[jj][1] + acc[jj][1]);
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * xld + 8 * jj) =
        __floats2bfloat162_rn(e1 * inter[jj][2] + acc[jj][2], e1 * inter[jj][3] + acc[jj][3]);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// One (row, head) walking its chunks backwards, carrying G, the gradient of
// the state leaving the chunk (dfinal, or zeros, at the end): the chunk's
// state gradient dsc = G as bf16 high and low planes (B, nc, H, 2, N, P);
// the decay's gradient times the decay, ddecay = exp(l_{Q-1}) <G, h_c> (B,
// H, nc), h_c the sum of its planes; then G = exp(l_{Q-1}) G + (exp(l) o
// C)^T . dy.  The C and dy rows of each 64-position tile come through a
// two-stage cp.async ring; a chunk's l is loaded during the chunk before.
// Grid (H, B), N / 16 warps.
template <int kN>
__global__ void __launch_bounds__(2 * kN) ssd_bwd_state(
    const bf16* __restrict__ Cm, const float* __restrict__ l, const bf16* __restrict__ states,
    const bf16* __restrict__ dy, const float* __restrict__ dfinal, bf16* __restrict__ dsc,
    float* __restrict__ ddecay, int S, int H, int G, int Q, int ld_bc) {
  constexpr int kLdN = kN + kPad;
  constexpr int kThreads = 2 * kN;
  constexpr int kRing = (kT * kLdN + kT * kLdP) * 2;   // a stage: C rows, then dy rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cw_hi = reinterpret_cast<bf16*>(smem + 2 * kRing);   // [kT][kLdN]: exp(l_t) C_t
  bf16* cw_lo = cw_hi + kT * kLdN;
  float* l_s = reinterpret_cast<float*>(cw_lo + kT * kLdN);  // [Q]
  float* red = l_s + Q;                                      // [warps]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int nc = S / Q, n_t = Q / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const int n0 = 16 * warp + r;
  const size_t hs = (static_cast<size_t>(b) * H + h) * S;
  const size_t nstate = static_cast<size_t>(kN) * kP;
  const size_t bld = ld_bc, xld = static_cast<size_t>(H) * kP;

  auto stage = [&](int idx) {   // tile idx % n_t of chunk nc - 1 - idx / n_t
    const uint32_t st = smem_u32(smem + (idx & 1) * kRing);
    const size_t row = static_cast<size_t>(b) * S +
                       static_cast<size_t>(nc - 1 - idx / n_t) * Q + (idx % n_t) * kT;
    stage_rows(st, kLdN, Cm + row * bld + g * kN, bld, kT, kN);
    stage_rows(st + kT * kLdN * 2, kLdP, dy + row * xld + static_cast<size_t>(h) * kP, xld, kT, kP);
  };
  constexpr int kPer = 256 / kThreads;   // l values a thread holds (Q <= 256)
  float lreg[kPer];
  auto load_l = [&](int c) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int s = threadIdx.x + e * kThreads;
      if (s < Q) lreg[e] = l[hs + static_cast<size_t>(c) * Q + s];
    }
  };

  float acc[8][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (dfinal != nullptr) {
      const float* src = dfinal + (static_cast<size_t>(b) * H + h) * nstate + 8 * jj + q2;
      const float2 u = *reinterpret_cast<const float2*>(src + n0 * kP);
      const float2 v = *reinterpret_cast<const float2*>(src + (n0 + 8) * kP);
      acc[jj][0] = u.x; acc[jj][1] = u.y; acc[jj][2] = v.x; acc[jj][3] = v.y;
    } else {
      acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.0f;
    }
  }
  stage(0);
  cp_async_commit();
  load_l(nc - 1);

  for (int c = nc - 1; c >= 0; --c) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int s = threadIdx.x + e * kThreads;
      if (s < Q) l_s[s] = lreg[e];
    }
    const size_t off = ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * nstate;
    store_planes(dsc + off, nstate, acc, n0, q2);
    float part = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const size_t o = off + static_cast<size_t>(n0 + 8 * hr) * kP + 8 * jj + q2;
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(states + o));
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(states + o + nstate));
        part += acc[jj][2 * hr] * (u.x + v.x) + acc[jj][2 * hr + 1] * (u.y + v.y);
      }
    }
    const float total = block_sum(part, red);   // its barriers also publish l_s
    if (c > 0) load_l(c - 1);
    const float decay = expf(l_s[Q - 1]);
    if (threadIdx.x == 0) ddecay[(static_cast<size_t>(b) * H + h) * nc + c] = decay * total;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] *= decay;
    }
    for (int t = 0; t < n_t; ++t) {
      const int idx = (nc - 1 - c) * n_t + t;
      if (idx + 1 < nc * n_t) {
        stage(idx + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* c_raw = reinterpret_cast<const bf16*>(smem + (idx & 1) * kRing);
      for (int i = threadIdx.x; i < kT * kN / 4; i += blockDim.x) {
        const int rr = i / (kN / 4);
        const int cc = (i % (kN / 4)) * 4;
        store_scaled_split(cw_hi + rr * kLdN + cc, cw_lo + rr * kLdN + cc,
                           load_bf16x4(c_raw + rr * kLdN + cc), expf(l_s[t * kT + rr]));
      }
      __syncthreads();
      const uint32_t dy_tile = smem_u32(smem + (idx & 1) * kRing) + kT * kLdN * 2;
#pragma unroll
      for (int k = 0; k < kT; k += 16) {
        uint32_t ah[4], al[4];
        ldA_T(smem_u32(cw_hi), kLdN, 16 * warp, k, ah);
        ldA_T(smem_u32(cw_lo), kLdN, 16 * warp, k, al);
#pragma unroll
        for (int jj = 0; jj < 8; jj += 2) {
          uint32_t bd[4];
          ldB_T(dy_tile, kLdP, 8 * jj, k, bd);
          mma(acc[jj], ah, bd[0], bd[1]);
          mma(acc[jj + 1], ah, bd[2], bd[3]);
          mma(acc[jj], al, bd[0], bd[1]);
          mma(acc[jj + 1], al, bd[2], bd[3]);
        }
      }
      __syncthreads();
    }
  }
}

// dCB of the tile pair (i, j), chunk c, group g: the sum over the group's
// heads, in order, of (dy_t . x_s) L[t, s] dt_s for s <= t, 0 above the
// diagonal; dcb (B, nc, G, Q, Q).  Each head's tiles come through a
// two-stage cp.async ring.  Grid (pairs, nc * G, B), 4 warps.
__global__ void __launch_bounds__(128) ssd_bwd_dcb(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, const float* __restrict__ l,
    const float* __restrict__ dth, float* __restrict__ dcb, int S, int H, int G, int Q) {
  extern __shared__ __align__(128) unsigned char smem[];
  // A stage: dy tile [kT][kLdP], x tile [kT][kLdP], l_t [kT], l_s [kT], dt_s [kT].
  constexpr int kStage = 2 * kT * kLdP * 2 + 3 * kT * 4;
  const uint32_t base = smem_u32(smem);
  int i, j;
  tile_pair(blockIdx.x, i, j);
  const int c = blockIdx.y / G, g = blockIdx.y % G, b = blockIdx.z;
  const int nc = S / Q;
  const int rep = H / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

  auto stage = [&](int buf, int h) {
    const uint32_t st = base + buf * kStage;
    stage_rows(st, kLdP, dy + ((row0 + i * kT) * H + h) * kP, static_cast<size_t>(H) * kP, kT, kP);
    stage_rows(st + kT * kLdP * 2, kLdP, x + ((row0 + j * kT) * H + h) * kP,
               static_cast<size_t>(H) * kP, kT, kP);
    const size_t hs = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q;
    const uint32_t f = st + 2 * kT * kLdP * 2;
    for (int e = threadIdx.x; e < 3 * kT / 4; e += blockDim.x) {
      const int which = e / (kT / 4), q = (e % (kT / 4)) * 4;
      const float* src = which == 0 ? l + hs + i * kT : (which == 1 ? l + hs + j * kT : dth + hs + j * kT);
      cp_async16(f + (which * kT + q) * 4, src + q);
    }
  };

  float acc[8][4] = {};
  stage(0, g * rep);
  cp_async_commit();
  for (int e = 0; e < rep; ++e) {
    if (e + 1 < rep) {
      stage((e + 1) & 1, g * rep + e + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t st = base + (e & 1) * kStage;
    const float* fl = reinterpret_cast<const float*>(smem + (e & 1) * kStage + 2 * kT * kLdP * 2);
    float tmp[8][4] = {};
#pragma unroll
    for (int k = 0; k < kP; k += 16) {
      uint32_t a[4];
      ldA(st, kLdP, 16 * warp, k, a);
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        uint32_t bx[4];
        ldB(st + kT * kLdP * 2, kLdP, 8 * jj, k, bx);
        mma(tmp[jj], a, bx[0], bx[1]);
        mma(tmp[jj + 1], a, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int tl = 16 * warp + r + 8 * hr;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int sl = 8 * jj + q2 + u;
          if (i * kT + tl >= j * kT + sl) {
            acc[jj][2 * hr + u] += tmp[jj][2 * hr + u] * expf(fl[tl] - fl[kT + sl]) * fl[2 * kT + sl];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = dcb + ((static_cast<size_t>(b) * nc + c) * G + g) * Q * Q +
               static_cast<size_t>(i * kT + 16 * warp + r) * Q + j * kT + q2;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<float2*>(out + 8 * jj) = make_float2(acc[jj][0], acc[jj][1]);
    *reinterpret_cast<float2*>(out + 8 * Q + 8 * jj) = make_float2(acc[jj][2], acc[jj][3]);
  }
}

// One 64-position tile j (as s) of chunk c, head h, row b: dx_s = sum_{t >=
// s} M[t, s] dy_t + w_s (B_s . dsc), M = (C . B^T) o L o dt; and each
// position's terms: ddtd (the direct dt gradient), dlc (-sum_t R[t, s] -
// dw_s w_s), dww (dw_s w_s, summed into the chunk's last l), all (B, H, S);
// rowpart (B, H, S, Q / 64), this tile's sum over s of R[t, s] = dM M for
// every t in the tiles at or past it.  The C . B^T tiles (t in tile i, s in
// tile j) come through a two-stage cp.async ring and are read transposed
// from shared memory; dsc's planes are staged after the walk, over dy's
// rows.  Grid (Q / 64, nc * H, B), 4 warps, 16 positions s each.
template <int kN>
__global__ void __launch_bounds__(128) ssd_bwd_dx(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const float* __restrict__ cb,
    const float* __restrict__ l, const float* __restrict__ dth, const bf16* __restrict__ dsc,
    const bf16* __restrict__ dy, bf16* __restrict__ dx, float* __restrict__ ddtd,
    float* __restrict__ dlc, float* __restrict__ dww, float* __restrict__ rowpart, int S, int H,
    int G, int Q, int ld_bc) {
  constexpr int kLdN = kN + kPad;
  constexpr int kLdC = kT + 4;   // a C . B^T tile's fp32 row (conflict-free transposed reads)
  // While walking the t tiles: a two-stage ring of dy rows and C . B^T
  // tiles; then, over them, B's rows and dsc's planes.
  constexpr int kWalk = 2 * (kT * kLdP * 2 + kT * kLdC * 4);
  constexpr int kFinal = (kT * kLdN + 2 * kN * kLdP) * 2;
  constexpr int kRegion = kWalk > kFinal ? kWalk : kFinal;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* x_tile = reinterpret_cast<bf16*>(smem);                           // [kT][kLdP]
  unsigned char* region = smem + kT * kLdP * 2;
  bf16* dy_ring = reinterpret_cast<bf16*>(region);                        // [2][kT][kLdP]
  float* cb_ring = reinterpret_cast<float*>(region + 2 * kT * kLdP * 2);  // [2][kT][kLdC]
  bf16* b_tile = reinterpret_cast<bf16*>(region);                         // [kT][kLdN]
  bf16* d_hi = b_tile + kT * kLdN;                                        // [kN][kLdP]
  bf16* d_lo = d_hi + kN * kLdP;
  float* l_s = reinterpret_cast<float*>(region + kRegion);
  float* dt_s = l_s + Q;
  float* red = dt_s + Q;                          // [4][kT]

  const int j = blockIdx.x;
  const int c = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = S / Q, n_t = Q / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t hs = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q;
  const size_t xld = static_cast<size_t>(H) * kP;
  const float* cbt = cb + ((static_cast<size_t>(b) * nc + c) * G + g) * Q * Q;

  auto stage = [&](int i) {   // dy rows of tile i; C . B^T rows t of tile i, columns s of tile j
    const int buf = (i - j) & 1;
    stage_rows(smem_u32(dy_ring + buf * kT * kLdP), kLdP, dy + ((row0 + i * kT) * H + h) * kP, xld,
               kT, kP);
    float* dst = cb_ring + buf * kT * kLdC;
    for (int e = threadIdx.x; e < kT * kT / 4; e += blockDim.x) {
      const int rr = e / (kT / 4), cc = (e % (kT / 4)) * 4;
      cp_async16(smem_u32(dst + rr * kLdC + cc),
                 cbt + static_cast<size_t>(i * kT + rr) * Q + j * kT + cc);
    }
  };
  stage_rows(smem_u32(x_tile), kLdP, x + ((row0 + j * kT) * H + h) * kP, xld, kT, kP);
  stage(j);
  cp_async_commit();
  for (int s = threadIdx.x; s < Q; s += blockDim.x) {
    l_s[s] = l[hs + s];
    dt_s[s] = dth[hs + s];
  }

  const int sl0 = 16 * warp + r;              // this thread's positions in the tile: sl0, sl0 + 8
  const int s0 = j * kT + sl0;                // ... in the chunk
  float dxa[8][4] = {};
  float col[2] = {0.0f, 0.0f}, ddi[2] = {0.0f, 0.0f};
  for (int i = j; i < n_t; ++i) {
    if (i + 1 < n_t) {
      stage(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cbs = cb_ring + ((i - j) & 1) * kT * kLdC;
    const uint32_t dys = smem_u32(dy_ring + ((i - j) & 1) * kT * kLdP);
    const float ls[2] = {l_s[s0], l_s[s0 + 8]};
    const float dts[2] = {dt_s[s0], dt_s[s0 + 8]};
    // dM^T[s, t] = x_s . dy_t for t in tile i.
    float tm[8][4] = {};
#pragma unroll
    for (int k = 0; k < kP; k += 16) {
      uint32_t a[4];
      ldA(smem_u32(x_tile), kLdP, 16 * warp, k, a);
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        uint32_t bd[4];
        ldB(dys, kLdP, 8 * jj, k, bd);
        mma(tm[jj], a, bd[0], bd[1]);
        mma(tm[jj + 1], a, bd[2], bd[3]);
      }
    }
    // M^T at the same places; R = dM M summed both ways, the dt term.
    float mv[8][4];
    float rowv[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tl = 8 * jj + q2 + u;
        const int t = i * kT + tl;
        rowv[jj][u] = 0.0f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int s = s0 + 8 * hr;
          float m = 0.0f;
          if (t >= s) {
            const float cbv = cbs[tl * kLdC + sl0 + 8 * hr];
            const float dec = expf(l_s[t] - ls[hr]);
            const float dm = tm[jj][2 * hr + u];
            m = cbv * dec * dts[hr];
            const float rr = dm * m;
            col[hr] += rr;
            ddi[hr] += dm * cbv * dec;
            rowv[jj][u] += rr;
          }
          mv[jj][2 * hr + u] = m;
        }
      }
    }
    // Row sums over s: the 8 lanes of a column, then the 4 warps in order.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = rowv[jj][u];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (r == 0) red[warp * kT + 8 * jj + q2 + u] = v;
      }
    }
    // dx += M^T . dy over tile i.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_frag(mv[2 * kk], mv[2 * kk + 1], ah, al);
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        uint32_t bd[4];
        ldB_T(dys, kLdP, 8 * jj, 16 * kk, bd);
        mma(dxa[jj], ah, bd[0], bd[1]);
        mma(dxa[jj + 1], ah, bd[2], bd[3]);
        mma(dxa[jj], al, bd[0], bd[1]);
        mma(dxa[jj + 1], al, bd[2], bd[3]);
      }
    }
    __syncthreads();
    if (threadIdx.x < kT) {
      const float v = red[threadIdx.x] + red[kT + threadIdx.x] + red[2 * kT + threadIdx.x] +
                      red[3 * kT + threadIdx.x];
      rowpart[(hs + i * kT + threadIdx.x) * n_t + j] = v;
    }
  }

  // The chunk's state: B's rows and dsc's planes over the ring, B_s . dsc,
  // then dx += w_s (B_s . dsc) and dw_s.
  __syncthreads();
  const bf16* planes = dsc + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * kN * kP;
  stage_rows(smem_u32(b_tile), kLdN, Bm + (row0 + j * kT) * ld_bc + g * kN, ld_bc, kT, kN);
  stage_rows(smem_u32(d_hi), kLdP, planes, kP, kN, kP);
  stage_rows(smem_u32(d_lo), kLdP, planes + kN * kP, kP, kN, kP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float tb[8][4] = {};
#pragma unroll
  for (int k = 0; k < kN; k += 16) {
    uint32_t a[4];
    ldA(smem_u32(b_tile), kLdN, 16 * warp, k, a);
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      uint32_t bh[4], bl[4];
      ldB_T(smem_u32(d_hi), kLdP, 8 * jj, k, bh);
      ldB_T(smem_u32(d_lo), kLdP, 8 * jj, k, bl);
      mma(tb[jj], a, bh[0], bh[1]);
      mma(tb[jj + 1], a, bh[2], bh[3]);
      mma(tb[jj], a, bl[0], bl[1]);
      mma(tb[jj + 1], a, bl[2], bl[3]);
    }
  }
  const float last = l_s[Q - 1];
  const float ls[2] = {l_s[s0], l_s[s0 + 8]};
  const float tail[2] = {expf(last - ls[0]), expf(last - ls[1])};
  const float w[2] = {tail[0] * dt_s[s0], tail[1] * dt_s[s0 + 8]};
  float dw[2] = {0.0f, 0.0f};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(x_tile + (sl0 + 8 * hr) * kLdP + 8 * jj + q2);
      const float2 xf = __bfloat1622float2(xv);
      dw[hr] += xf.x * tb[jj][2 * hr] + xf.y * tb[jj][2 * hr + 1];
      dxa[jj][2 * hr] += w[hr] * tb[jj][2 * hr];
      dxa[jj][2 * hr + 1] += w[hr] * tb[jj][2 * hr + 1];
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dw[hr] += __shfl_xor_sync(kFull, dw[hr], off);
      col[hr] += __shfl_xor_sync(kFull, col[hr], off);
      ddi[hr] += __shfl_xor_sync(kFull, ddi[hr], off);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t p = hs + s0 + 8 * hr;
      ddtd[p] = ddi[hr] + dw[hr] * tail[hr];
      dlc[p] = -col[hr] - dw[hr] * w[hr];
      dww[p] = dw[hr] * w[hr];
    }
  }
  bf16* out = dx + ((row0 + s0) * H + h) * kP + q2;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) = __floats2bfloat162_rn(dxa[jj][0], dxa[jj][1]);
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * xld + 8 * jj) =
        __floats2bfloat162_rn(dxa[jj][2], dxa[jj][3]);
  }
}

// dB and dC of tile k (64 positions) of chunk c, group g, split `split` of
// the group's heads, into slot `split` of dbpart / dcpart (B, S, splits + 1,
// G, N): warps 0-3 dC (16 rows t each), warps 4-7 dB (16 rows s each).  A
// heads split sums, over its heads in order, exp(l_t) (dy_t . h_c^T) into
// dC (and writes dli_t = exp(l_t) C_t . (dy_t . h_c^T), (B, H, S)) and w_s
// (x_s . dsc^T) into dB, each head's tiles and planes through a two-stage
// cp.async ring; the last split sums dCB . B into dC and dCB^T . C into
// dB.  Grid (Q / 64, nc * G * (splits + 1), B), 8 warps.
template <int kN>
__global__ void __launch_bounds__(256, 1) ssd_bwd_dbdc(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ l, const float* __restrict__ dth, const bf16* __restrict__ states,
    const bf16* __restrict__ dsc, const bf16* __restrict__ dy, const float* __restrict__ dcb,
    float* __restrict__ dbpart, float* __restrict__ dcpart, float* __restrict__ dli, int S, int H,
    int G, int Q, int hps, int ld_bc) {
  constexpr int kLdN = kN + kPad;
  constexpr int kNT = kN / 8;
  // A stage: dy and x tiles [kT][kLdP], the planes of h_c and dsc [kN][kLdP]
  // each, then l and dt of the tile [kT] and the chunk's last 4 l.
  constexpr int kStageB = (2 * kT + 4 * kN) * kLdP * 2;
  constexpr int kStage = kStageB + (2 * kT + 4) * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = blockIdx.x;
  const int splits = H / G / hps;
  const int split = blockIdx.y % (splits + 1);
  const int c = blockIdx.y / (splits + 1) / G, g = blockIdx.y / (splits + 1) % G;
  const int b = blockIdx.z;
  const int nc = S / Q, n_t = Q / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int role = warp >> 2, wr = warp & 3;   // role 0: dC, role 1: dB
  const int r = lane >> 2, q2 = 2 * (lane & 3);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t xld = static_cast<size_t>(H) * kP, bld = ld_bc, gn = static_cast<size_t>(G) * kN;
  const size_t nstate = static_cast<size_t>(kN) * kP;
  const int pl0 = 16 * wr + r;   // this thread's rows in tile k: pl0, pl0 + 8

  float acc[kNT][4] = {};
  if (split < splits) {
    const uint32_t base = smem_u32(smem);
    bf16* c_tile = reinterpret_cast<bf16*>(smem + 2 * kStage);   // [kT][kLdN]
    auto head = [&](int e) { return (g * splits + split) * hps + e; };
    auto stage = [&](int buf, int h) {
      const uint32_t st = base + buf * kStage;
      const size_t hs = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q;
      const bf16* hp = states + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * nstate;
      const bf16* dp = dsc + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * nstate;
      stage_rows(st, kLdP, dy + ((row0 + k * kT) * H + h) * kP, xld, kT, kP);
      stage_rows(st + kT * kLdP * 2, kLdP, x + ((row0 + k * kT) * H + h) * kP, xld, kT, kP);
      stage_rows(st + 2 * kT * kLdP * 2, kLdP, hp, kP, 2 * kN, kP);
      stage_rows(st + (2 * kT + 2 * kN) * kLdP * 2, kLdP, dp, kP, 2 * kN, kP);
      const uint32_t f = st + kStageB;
      for (int e = threadIdx.x; e < kT / 2 + 1; e += blockDim.x) {
        const float* src = e < kT / 4 ? l + hs + k * kT + 4 * e
                                      : (e < kT / 2 ? dth + hs + k * kT + 4 * (e - kT / 4)
                                                    : l + hs + Q - 4);
        cp_async16(f + 16 * e, src);
      }
    };
    stage_rows(smem_u32(c_tile), kLdN, Cm + (row0 + k * kT) * bld + g * kN, bld, kT, kN);
    stage(0, head(0));
    cp_async_commit();
    for (int e = 0; e < hps; ++e) {
      const int h = head(e);
      if (e + 1 < hps) {
        stage((e + 1) & 1, head(e + 1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t st = base + (e & 1) * kStage;
      const float* fl = reinterpret_cast<const float*>(smem + (e & 1) * kStage + kStageB);
      const float* l_s = fl;             // [kT]
      const float* dt_s = fl + kT;       // [kT]
      const float last = fl[2 * kT + 3];
      // role 0: dy . h_c^T; role 1: x . dsc^T.
      const uint32_t a_tile = st + role * kT * kLdP * 2;
      const uint32_t b_hi = st + (2 * kT + 2 * kN * role) * kLdP * 2;
      const uint32_t b_lo = b_hi + kN * kLdP * 2;
      uint32_t af[4][4];
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) ldA(a_tile, kLdP, 16 * wr, 16 * kp, af[kp]);
      float scale[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = pl0 + 8 * hr;
        scale[hr] = role == 0 ? expf(l_s[p]) : expf(last - l_s[p]) * dt_s[p];
      }
      float dl[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < kNT; jj += 2) {
        float t0[4] = {}, t1[4] = {};
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          uint32_t bh[4], bl[4];
          ldB(b_hi, kLdP, 8 * jj, 16 * kp, bh);
          ldB(b_lo, kLdP, 8 * jj, 16 * kp, bl);
          mma(t0, af[kp], bh[0], bh[1]);
          mma(t1, af[kp], bh[2], bh[3]);
          mma(t0, af[kp], bl[0], bl[1]);
          mma(t1, af[kp], bl[2], bl[3]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          acc[jj][2 * hr] += scale[hr] * t0[2 * hr];
          acc[jj][2 * hr + 1] += scale[hr] * t0[2 * hr + 1];
          acc[jj + 1][2 * hr] += scale[hr] * t1[2 * hr];
          acc[jj + 1][2 * hr + 1] += scale[hr] * t1[2 * hr + 1];
          if (role == 0) {
            const bf16* crow = c_tile + (pl0 + 8 * hr) * kLdN + 8 * jj + q2;
            const float2 c0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow));
            const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + 8));
            dl[hr] += c0.x * t0[2 * hr] + c0.y * t0[2 * hr + 1] + c1.x * t1[2 * hr] +
                      c1.y * t1[2 * hr + 1];
          }
        }
      }
      if (role == 0) {
        const size_t hs = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          dl[hr] += __shfl_xor_sync(kFull, dl[hr], 1);
          dl[hr] += __shfl_xor_sync(kFull, dl[hr], 2);
          if ((lane & 3) == 0) dli[hs + k * kT + pl0 + 8 * hr] = scale[hr] * dl[hr];
        }
      }
      __syncthreads();
    }
  } else {
    bf16* bt = reinterpret_cast<bf16*>(smem);   // [kT][kLdN]: B rows of tile u <= k
    bf16* ct = bt + kT * kLdN;                  // [kT][kLdN]: C rows of tile u >= k
    const float* dct = dcb + ((static_cast<size_t>(b) * nc + c) * G + g) * Q * Q;
    for (int u = 0; u < n_t; ++u) {
      if (u <= k) stage_rows(smem_u32(bt), kLdN, Bm + (row0 + u * kT) * bld + g * kN, bld, kT, kN);
      if (u >= k) stage_rows(smem_u32(ct), kLdN, Cm + (row0 + u * kT) * bld + g * kN, bld, kT, kN);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if ((role == 0 && u <= k) || (role == 1 && u >= k)) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float v[2][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = u * kT + 16 * kk + 8 * half + q2;   // the other index, in the chunk
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int p = k * kT + pl0 + 8 * hr;             // this row's index
              if (role == 0) {   // dCB[t = p][s = q .. q + 1]
                const float2 d = *reinterpret_cast<const float2*>(dct + static_cast<size_t>(p) * Q + q);
                v[half][2 * hr] = d.x;
                v[half][2 * hr + 1] = d.y;
              } else {           // dCB[t = q .. q + 1][s = p]
                v[half][2 * hr] = dct[static_cast<size_t>(q) * Q + p];
                v[half][2 * hr + 1] = dct[static_cast<size_t>(q + 1) * Q + p];
              }
            }
          }
          uint32_t ah[4], al[4];
          split_frag(v[0], v[1], ah, al);
          const uint32_t src = smem_u32(role == 0 ? bt : ct);
#pragma unroll
          for (int jj = 0; jj < kNT; jj += 2) {
            uint32_t bb[4];
            ldB_T(src, kLdN, 8 * jj, 16 * kk, bb);
            mma(acc[jj], ah, bb[0], bb[1]);
            mma(acc[jj + 1], ah, bb[2], bb[3]);
            mma(acc[jj], al, bb[0], bb[1]);
            mma(acc[jj + 1], al, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();
    }
  }
  float* part = role == 0 ? dcpart : dbpart;
  const size_t slots = static_cast<size_t>(splits) + 1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* out = part + ((row0 + k * kT + pl0 + 8 * hr) * slots + split) * gn + g * kN + q2;
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj) {
      *reinterpret_cast<float2*>(out + 8 * jj) = make_float2(acc[jj][2 * hr], acc[jj][2 * hr + 1]);
    }
  }
}

// One chunk c of head h, row b, a thread a position t: dl_t = sum of this
// tile's rowpart entries + dlc_t + dli_t (+ the chunk's sum of dww and its
// ddecay at t = Q - 1), summed backwards over the chunk into da_t, the
// gradient of A dt_t; ddt_t = ddtd_t + A da_t (B, S, H); dapart (B, H, nc) =
// sum_t dt_t da_t.  Grid (nc, H, B), Q threads.
__global__ void __launch_bounds__(256) ssd_bwd_dt(
    const float* __restrict__ A, const float* __restrict__ dth, const float* __restrict__ rowpart,
    const float* __restrict__ ddtd, const float* __restrict__ dlc, const float* __restrict__ dli,
    const float* __restrict__ dww, const float* __restrict__ ddecay, float* __restrict__ ddt,
    float* __restrict__ dapart, int S, int H, int Q) {
  __shared__ float red[8];
  __shared__ float suffix[8];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int nc = S / Q, n_t = Q / kT;
  const int warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
  const size_t p = (static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q + t;

  float dl = 0.0f;
  for (int jt = 0; jt <= t / kT; ++jt) dl += rowpart[p * n_t + jt];
  dl += dlc[p] + dli[p];
  const float wsum = block_sum(dww[p], red);
  if (t == Q - 1) dl += wsum + ddecay[(static_cast<size_t>(b) * H + h) * nc + c];

  // da_t = sum_{u >= t} dl_u: within the warp, then the later warps' totals.
  float incl = dl;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += o;
  }
  if (lane == 0) suffix[warp] = incl;
  __syncthreads();
  float later = 0.0f;
  for (int w = warps - 1; w > warp; --w) later += suffix[w];
  const float da = incl + later;

  const float dtv = dth[p];
  ddt[(static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q + t) * H + h] = ddtd[p] + A[h] * da;
  const float part = block_sum(dtv * da, red);
  if (t == 0) dapart[(static_cast<size_t>(b) * H + h) * nc + c] = part;
}

// dB and dC: the slots summed in order, rounded to bf16; dA (H) = the sum
// of dapart over rows and chunks, in order.  One thread an element.
__global__ void __launch_bounds__(256) ssd_bwd_reduce(
    const float* __restrict__ dbpart, const float* __restrict__ dcpart,
    const float* __restrict__ dapart, bf16* __restrict__ dB, bf16* __restrict__ dC,
    float* __restrict__ dA, int Bsz, int S, int H, int GN, int slots, int nc) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(Bsz) * S * GN;
  if (idx < total) {
    const size_t bs = idx / GN, gn = idx % GN;
    float sb = 0.0f, sc = 0.0f;
    for (int sl = 0; sl < slots; ++sl) {
      const size_t o = (bs * slots + sl) * GN + gn;
      sb += dbpart[o];
      sc += dcpart[o];
    }
    dB[idx] = __float2bfloat16_rn(sb);
    dC[idx] = __float2bfloat16_rn(sc);
  }
  if (idx < static_cast<size_t>(H)) {
    float s = 0.0f;
    for (int b = 0; b < Bsz; ++b) {
      for (int c = 0; c < nc; ++c) s += dapart[(static_cast<size_t>(b) * H + idx) * nc + c];
    }
    dA[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// Allow `kKernel` `smem` bytes of dynamic shared memory; the attribute is
// set again only when a launch asks for more than the last one set.
template <auto kKernel>
cudaError_t prepare(size_t smem) {
  static size_t allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

#define SSD_CHECK(expr)                                   \
  do {                                                    \
    const cudaError_t err_ = (expr);                      \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

template <int kN>
int launch_fwd(const void* x_, const void* dt_, const void* A_, const void* Bm_, const void* Cm_,
               const void* init_, void* y_, void* final_, void* cb_, void* l_, void* dth_,
               void* states_, int Bsz, int S, int H, int G, int Q, int ld_bc, cudaStream_t st) {
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* Bm = static_cast<const bf16*>(Bm_);
  const bf16* Cm = static_cast<const bf16*>(Cm_);
  const float* dt = static_cast<const float*>(dt_);
  const float* A = static_cast<const float*>(A_);
  const float* init = static_cast<const float*>(init_);
  bf16* y = static_cast<bf16*>(y_);
  float* final_state = static_cast<float*>(final_);
  float* cb = static_cast<float*>(cb_);
  float* l = static_cast<float*>(l_);
  float* dth = static_cast<float*>(dth_);
  bf16* states = static_cast<bf16*>(states_);
  constexpr int kLdN = kN + kPad;
  const int nc = S / Q, n_t = Q / kT;
  const size_t cb_smem = 2 * kT * kLdN * 2;
  const size_t state_smem = (2 * kT * kLdN + 4 * kT * kLdP) * 2 + 2 * Q * 4;
  const size_t scan_smem = (kT * kLdN + 2 * kN * kLdP + 2 * kT * kLdP) * 2 + 2 * Q * 4;
  SSD_CHECK(prepare<ssd_cb<kN>>(cb_smem));
  SSD_CHECK(prepare<ssd_state_fwd<kN>>(state_smem));
  SSD_CHECK(prepare<ssd_chunk_scan<kN>>(scan_smem));
  ssd_cb<kN><<<dim3(n_t * (n_t + 1) / 2, nc * G, Bsz), 128, cb_smem, st>>>(Bm, Cm, cb, S, G, Q, ld_bc);
  SSD_CHECK(cudaGetLastError());
  ssd_state_fwd<kN><<<dim3(H, Bsz), 2 * kN, state_smem, st>>>(x, dt, A, Bm, init, l, dth, states,
                                                              final_state, S, H, G, Q, ld_bc);
  SSD_CHECK(cudaGetLastError());
  ssd_chunk_scan<kN><<<dim3(n_t, nc * H, Bsz), 128, scan_smem, st>>>(x, Cm, cb, l, dth, states, y,
                                                                      S, H, G, Q, ld_bc);
  return static_cast<int>(cudaGetLastError());
}

template <int kN>
int launch_bwd(const void* x_, const void* A_, const void* Bm_, const void* Cm_, const void* cb_,
               const void* l_, const void* dth_, const void* states_, const void* dy_,
               const void* dfinal_, void* dsc_, void* ddecay_, void* dcb_, void* rowpart_,
               void* ddtd_, void* dlc_, void* dww_, void* dli_, void* dbpart_, void* dcpart_,
               void* dapart_, void* dx_, void* ddt_, void* dA_, void* dB_, void* dC_, int Bsz,
               int S, int H, int G, int Q, int hps, int ld_bc, cudaStream_t st) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* Bm = static_cast<const bf16*>(Bm_);
  const bf16* Cm = static_cast<const bf16*>(Cm_);
  const bf16* dy = static_cast<const bf16*>(dy_);
  const float *A = f(A_), *cb = f(cb_), *l = f(l_), *dth = f(dth_);
  const bf16* states = static_cast<const bf16*>(states_);
  const float* dfinal = f(dfinal_);
  bf16* dsc = static_cast<bf16*>(dsc_);
  float *ddecay = m(ddecay_), *dcb = m(dcb_), *rowpart = m(rowpart_);
  float *ddtd = m(ddtd_), *dlc = m(dlc_), *dww = m(dww_), *dli = m(dli_);
  float *dbpart = m(dbpart_), *dcpart = m(dcpart_), *dapart = m(dapart_);
  float *ddt = m(ddt_), *dA = m(dA_);
  bf16* dx = static_cast<bf16*>(dx_);
  bf16* dB = static_cast<bf16*>(dB_);
  bf16* dC = static_cast<bf16*>(dC_);
  constexpr int kLdN = kN + kPad;
  const int nc = S / Q, n_t = Q / kT;
  const int splits = H / G / hps;
  const size_t state_smem = (4 * kT * kLdN + 2 * kT * kLdP) * 2 + (Q + 8) * 4;
  const size_t dcb_smem = 2 * (2 * kT * kLdP * 2 + 3 * kT * 4);
  const size_t dx_walk = 2 * (kT * kLdP * 2 + kT * (kT + 4) * 4);
  const size_t dx_final = (kT * kLdN + 2 * kN * kLdP) * 2;
  const size_t dx_smem = kT * kLdP * 2 + (dx_walk > dx_final ? dx_walk : dx_final) +
                         (2 * Q + 4 * kT) * 4;
  const size_t heads_smem = 2 * ((2 * kT + 4 * kN) * kLdP * 2 + (2 * kT + 4) * 4) + kT * kLdN * 2;
  const size_t cbpart_smem = 2 * kT * kLdN * 2;
  const size_t dbdc_smem = heads_smem > cbpart_smem ? heads_smem : cbpart_smem;
  SSD_CHECK(prepare<ssd_bwd_state<kN>>(state_smem));
  SSD_CHECK(prepare<ssd_bwd_dcb>(dcb_smem));
  SSD_CHECK(prepare<ssd_bwd_dx<kN>>(dx_smem));
  SSD_CHECK(prepare<ssd_bwd_dbdc<kN>>(dbdc_smem));

  ssd_bwd_state<kN><<<dim3(H, Bsz), 2 * kN, state_smem, st>>>(Cm, l, states, dy, dfinal, dsc,
                                                              ddecay, S, H, G, Q, ld_bc);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_dcb<<<dim3(n_t * (n_t + 1) / 2, nc * G, Bsz), 128, dcb_smem, st>>>(x, dy, l, dth, dcb, S,
                                                                             H, G, Q);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_dx<kN><<<dim3(n_t, nc * H, Bsz), 128, dx_smem, st>>>(x, Bm, cb, l, dth, dsc, dy, dx, ddtd,
                                                               dlc, dww, rowpart, S, H, G, Q, ld_bc);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_dbdc<kN><<<dim3(n_t, nc * G * (splits + 1), Bsz), 256, dbdc_smem, st>>>(
      x, Bm, Cm, l, dth, states, dsc, dy, dcb, dbpart, dcpart, dli, S, H, G, Q, hps, ld_bc);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_dt<<<dim3(nc, H, Bsz), Q, 0, st>>>(A, dth, rowpart, ddtd, dlc, dli, dww, ddecay, ddt,
                                              dapart, S, H, Q);
  SSD_CHECK(cudaGetLastError());
  const size_t total = static_cast<size_t>(Bsz) * S * G * kN;
  const size_t n = total > static_cast<size_t>(H) ? total : static_cast<size_t>(H);
  ssd_bwd_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      dbpart, dcpart, dapart, dB, dC, dA, Bsz, S, H, G * kN, splits + 1, nc);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int Bsz, int S, int H, int G, int N, int Q) {
  return Bsz > 0 && S > 0 && H > 0 && G > 0 && H % G == 0 && (N == 64 || N == 128) &&
         (Q == 64 || Q == 128 || Q == 256) && S % Q == 0 && Bsz <= 65535 &&
         static_cast<long long>(S / Q) * H <= 65535;
}

}  // namespace

extern "C" {

// The forward: y (as x), the final state (B, H, N, P) fp32, and what the
// other stages and the backward read: cb (B, nc, G, Q, Q), l and dt by head
// (B, H, S), fp32, and the entering states as bf16 planes (B, nc, H, 2, N,
// P).  `init` may be
// null (a zero state).  Three launches on `stream`; returns the first
// cudaError_t that is not cudaSuccess (cudaErrorInvalidValue for shapes the
// kernels do not take).
int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                  const void* init, void* y, void* final_state, void* cb, void* l, void* dth,
                  void* states, int Bsz, int S, int H, int G, int N, int Q, int ld_bc,
                  void* stream) {
  if (!valid(Bsz, S, H, G, N, Q) || ld_bc < G * N || ld_bc % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N == 64 ? launch_fwd<64>(x, dt, A, Bm, Cm, init, y, final_state, cb, l, dth, states, Bsz,
                                  S, H, G, Q, ld_bc, st)
                 : launch_fwd<128>(x, dt, A, Bm, Cm, init, y, final_state, cb, l, dth, states, Bsz,
                                   S, H, G, Q, ld_bc, st);
}

// The backward from the forward's saved cb, l, dt by head and states, the
// output's gradient dy (as x) and the final state's dfinal (null: zeros):
// dx (as x), ddt (B, S, H) and dA (H) fp32, dB and dC (as B, C).  The
// scratch: dsc (planes, as states), ddecay and dapart (B, H, nc), dcb (as cb),
// rowpart (B, H, S, Q / 64), ddtd, dlc, dww and dli (B, H, S), dbpart and
// dcpart (B, S, H / G / hps + 1, G, N).  Six launches on `stream`.
int repro_ssd_bwd(const void* x, const void* A, const void* Bm, const void* Cm, const void* cb,
                  const void* l, const void* dth, const void* states, const void* dy,
                  const void* dfinal, void* dsc, void* ddecay, void* dcb, void* rowpart,
                  void* ddtd, void* dlc, void* dww, void* dli, void* dbpart, void* dcpart,
                  void* dapart, void* dx, void* ddt, void* dA, void* dB, void* dC, int Bsz, int S,
                  int H, int G, int N, int Q, int hps, int ld_bc, void* stream) {
  if (!valid(Bsz, S, H, G, N, Q) || hps < 1 || (H / G) % hps != 0 || ld_bc < G * N || ld_bc % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N == 64 ? launch_bwd<64>(x, A, Bm, Cm, cb, l, dth, states, dy, dfinal, dsc, ddecay, dcb,
                                  rowpart, ddtd, dlc, dww, dli, dbpart, dcpart, dapart, dx, ddt,
                                  dA, dB, dC, Bsz, S, H, G, Q, hps, ld_bc, st)
                 : launch_bwd<128>(x, A, Bm, Cm, cb, l, dth, states, dy, dfinal, dsc, ddecay, dcb,
                                   rowpart, ddtd, dlc, dww, dli, dbpart, dcpart, dapart, dx, ddt,
                                   dA, dB, dC, Bsz, S, H, G, Q, hps, ld_bc, st);
}

}  // extern "C"
