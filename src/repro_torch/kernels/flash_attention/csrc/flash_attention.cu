// flash_attention for Hopper (sm_90a): forward blocked online-softmax
// attention with GQA, causal and sliding-window masks, and its backward
// (the second half of this file), which training differentiates through.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (`_kernel`, launched by
// `flash_attention_kernel`).  That kernel walks a (BH, Sq/bq, Sk/bk) grid
// whose last axis runs in order on one core, carrying the running max,
// sum and accumulator in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in no order, so here one block owns one
// (batch*head, 64-row query tile) and runs the KV loop itself.  The dtype
// alone picks one of two kernels:
//
// bf16 -- `flash_fwd_tc`, FlashAttention-2 on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators):
//
//   * 4 warps; each owns 16 query rows.  Its Q fragments (d_pad / 16
//     k-steps, d_pad = d rounded up to 16) are loaded once with ldmatrix
//     and stay in registers for the whole KV loop, beside the f32 output
//     accumulator (d_pad / 8 n8-tiles), the row's running max and sum;
//   * 64-key K and V tiles in bf16, double-buffered in shared memory and
//     loaded with 16-byte cp.async (zero-filled past the sequence end), so
//     the next tile's copy overlaps this tile's math.  A row holds d_pad
//     elements, unpadded and XOR-swizzled when d_pad is 64 or 128, else
//     padded by 8 (240 B at d = 112), so ldmatrix is conflict-free.  Two
//     stages of K and V take 4 * 64 * pitch * 2 bytes: 61,440 B at d = 112
//     (Q is staged once in the second stage before the loop);
//   * S = Q K^T with K fragments from ldmatrix.x4; the causal, window and
//     ragged-edge masks act on the accumulator fragment from each
//     element's (row, key) position, and only on tiles that cross an
//     edge for the warp; tiles no row can see are skipped, per block and
//     per warp;
//   * the online softmax keeps max and sum per thread, reduces the max
//     over the row's quad with __shfl_xor_sync and the sum once at the
//     end; a masked probability is exactly 0 (exp2 of -inf), so a row with
//     no visible key ends with l == 0 and writes 0;
//   * P is rounded to bf16 in registers: the S accumulator layout is the
//     A-operand layout, so P never touches shared memory.  O += P V with
//     V fragments from ldmatrix.x4.trans.  The only roundings besides
//     the bf16 inputs and output are P's (tests/
//     test_torch_tensor_core_rounding.py models them).
//
// f32 -- `flash_fwd<float>`, the scalar kernel of the first port, kept for
// the f32 checks (2e-5), which bf16 tensor cores cannot meet: 256
// threads, four per query row, Q/K/V tiles in f32 shared memory, scalar
// FMAs.
//
// Bound on this card: bytes.  The kernel must read q, k and v once and
// write o once: at the serve shape (B = 4, S = 512, H = K = 32, d = 112,
// bf16) that is 58.7 MB, 17.5 us at 3.35 TB/s, while its causal work,
// 2 * 2 * B * H * d * S (S + 1) / 2 = 7.5 GFLOP, takes 7.6 us at the bf16
// tensor-core peak.  What keeps the bf16 kernel off that bound: each K/V
// tile is read from device memory by every query tile of its head (8 at
// S = 512; the L2 absorbs most of it), mma.sync reaches only part of the
// wgmma rate, the diagonal tiles compute their masked upper half, and
// 1,024 blocks of unequal causal length leave a tail (the grid starts
// the longest first).  chip_smoke.py measures it at about 0.08 ms on an
// H100 SXM at 700 W, some 4.6x the bound and 1.5x PyTorch's
// scaled_dot_product_attention on the same tensors.  182 registers a
// thread allow two blocks an SM; wgmma fed by a TMA ring is the next step.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernels
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tma_wgmma.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // four threads per query row
constexpr int kMaxD = 128;        // head dims up to this
constexpr int kCols = kMaxD / 4;  // accumulator columns per thread
constexpr int kKeys = kBK / 4;    // scores per thread per KV tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (d + 1) +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int Sq, int Sk, int H, int K, int d,
          int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sq = smem;                  // [kBQ][ld]
  float* sk = sq + kBQ * ld;         // [kBK][ld]
  float* sv = sk + kBK * ld;         // [kBK][ld]
  float* sp = sv + kBK * ld;         // [kBQ][kBK + 1] probabilities

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;          // 0 .. kBQ-1
  const int sub = tid & 3;           // lane within the row's four
  const int qpos = q0 + row;

  // element (batch b, position s, head j, column c) of [B, S, heads, d]
  const size_t q_row = (size_t)H * d;
  const size_t kv_row = (size_t)K * d;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int s = q0 + r;
    sq[r * ld + c] = s < Sq ? to_f32(qb[(size_t)s * q_row + c]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // skip tiles no row of this query tile can see (uniform per block)
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int s = k0 + r;
      const bool in = s < Sk;
      sk[r * ld + c] = in ? to_f32(kb[(size_t)s * kv_row + c]) : 0.f;
      sv[r * ld + c] = in ? to_f32(vb[(size_t)s * kv_row + c]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys k0 + sub + 4 * jj
    float s[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) s[jj] = 0.f;
    const float* qr = sq + row * ld;
    for (int e = 0; e < d; ++e) {
      const float qe = qr[e];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
        s[jj] = fmaf(qe, sk[(sub + 4 * jj) * ld + e], s[jj]);
    }
    unsigned visible = 0;
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int kpos = k0 + sub + 4 * jj;
      const bool vis = kpos < Sk && (!causal || kpos <= qpos) &&
                       (window <= 0 || kpos > qpos - window);
      s[jj] = vis ? s[jj] * scale : kNegInf;
      visible |= (unsigned)vis << jj;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* pr = sp + row * (kBK + 1);
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float p = (visible >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
      pr[sub + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                    // the row's four threads share pr

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = pr[kk];
      const float* vr = sv + kk * ld + sub;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (sub + 4 * j < d) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  if (lse != nullptr && qpos < Sq && sub == 0)
    lse[(size_t)bh * Sq + qpos] = l > 0.f ? m + logf(l) : CUDART_INF_F;
  if (qpos < Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = o + ((size_t)b * Sq + qpos) * q_row + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + 4 * j;
      if (c < d) orow[c] = from_f32<T>(acc[j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Sq, int Sk, int H, int K, int d,
           int causal, int window, float scale, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, K, d,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;                 // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

size_t tc_smem_bytes(int d) {
  const int dp = (d + 15) / 16 * 16;
  return sizeof(bf16) * 4 * (size_t)kBK * tc::tile_pitch(dp);
}

// Rows [s0, s0 + 64) of one head into a [64][pitch] bf16 tile; rows past
// `len` are zero.  vec: 16-byte cp.async (d % 8 == 0, aligned), else plain
// element loads.  Columns [d, d_pad) are zeroed once by the caller.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t row_stride, int s0,
                                          int len, int d, int pitch, int swz,
                                          bool vec) {
  if (vec) {
    const int chunks = d >> 3;
    for (int i = threadIdx.x; i < kBK * chunks; i += kTcThreads) {
      const int r = i / chunks, c = (i - r * chunks) << 3;
      const int s = s0 + r;
      const bool in = s < len;
      tc::cp_async16(dst + tc::tile_off(r, c, pitch, swz),
                     in ? src + (size_t)s * row_stride + c : src,
                     in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * d; i += kTcThreads) {
      const int r = i / d, c = i - r * d;
      const int s = s0 + r;
      dst[tc::tile_off(r, c, pitch, swz)] =
          s < len ? src[(size_t)s * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>   // head dim rounded up to a multiple of 16
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int K, int d,
             int causal, int window, float scale_log2, int vec) {
  constexpr int KS = DP / 16;        // k-steps of Q K^T
  constexpr int DT = DP / 8;         // n8-tiles of O
  constexpr int NT = kBK / 8;        // n8-tiles of S
  constexpr int PITCH = tc::tile_pitch(DP);
  constexpr int SWZ = tc::tile_swz(DP);
  constexpr int TILE = kBK * PITCH;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* const sbuf = reinterpret_cast<bf16*>(fa_smem);
  // stage s: K at sbuf + 2 s TILE, V at sbuf + (2 s + 1) TILE; Q is staged
  // in stage 1's K before the loop

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // grid (B*H, query tiles): every head's last query tile, the longest
  // under a causal mask, is scheduled first, the first tiles last
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * d, kv_row = (size_t)K * d;
  const bf16* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
  const bf16* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * d;
  const bf16* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * d;

  // zero the padding columns [d, DP) of every tile once: no load writes
  // them, and a K pad must not meet Q's zeros as NaN
  if (d < DP) {
    const int w = DP - d;
    for (int i = threadIdx.x; i < 4 * kBK * w; i += kTcThreads) {
      const int r = i / w, c = d + (i - r * w);
      sbuf[(r / kBK) * TILE + tc::tile_off(r % kBK, c, PITCH, SWZ)] =
          __float2bfloat16(0.f);
    }
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int t_end = (Sk + kBK - 1) / kBK;
  if (causal) t_end = min(t_end, q_last / kBK + 1);
  int t_begin = 0;                   // tiles wholly left of every window
  if (window > 0 && q0 - window - (kBK - 1) >= 0)
    t_begin = (q0 - window - (kBK - 1)) / kBK + 1;

  load_tile(sbuf + 2 * TILE, qb, q_row, q0, Sq, d, PITCH, SWZ, vec);
  if (t_begin < t_end) {
    load_tile(sbuf, kb, kv_row, t_begin * kBK, Sk, d, PITCH, SWZ, vec);
    load_tile(sbuf + TILE, vb, kv_row, t_begin * kBK, Sk, d, PITCH, SWZ,
              vec);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
  {
    const bf16* sq = sbuf + 2 * TILE;
    const int r = warp * 16 + (lane & 15);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::ldsm_x4(qf[ks],
                  sq + tc::tile_off(r, ks * 16 + (lane >> 4) * 8, PITCH, SWZ));
  }
  __syncthreads();                   // Q is in registers: stage 1 is free

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;    // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
  const int w_first = q0 + warp * 16, w_last = w_first + 15;
  const int r0 = w_first + (lane >> 2), r1 = r0 + 8;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {             // prefetch the next tile
      bf16* nk = sbuf + 2 * (st ^ 1) * TILE;
      load_tile(nk, kb, kv_row, (t + 1) * kBK, Sk, d, PITCH, SWZ, vec);
      load_tile(nk + TILE, vb, kv_row, (t + 1) * kBK, Sk, d, PITCH, SWZ,
                vec);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sbuf + 2 * st * TILE;
    const bf16* sv = sk + TILE;
    const int k0 = t * kBK;
    const bool skip = (causal && k0 > w_last) ||
                      (window > 0 && k0 + kBK - 1 <= w_first - window);
    if (!skip) {                     // warp-uniform
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          tc::ldsm_x4(bk, sk + tc::tile_off(
                                   np * 16 + (lane & 7) + (lane >> 4) * 8,
                                   ks * 16 + ((lane >> 3) & 1) * 8, PITCH,
                                   SWZ));
          tc::mma(s[2 * np], qf[ks], bk[0], bk[1]);
          tc::mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
        }
      }
      const bool full = k0 + kBK <= Sk &&
                        (!causal || k0 + kBK - 1 <= w_first) &&
                        (window <= 0 || k0 > w_last - window);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!full) {
            const int kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int qp = e < 2 ? r0 : r1;
            const bool vis = kp < Sk && (!causal || kp <= qp) &&
                             (window <= 0 || kp > qp - window);
            x = vis ? x : -CUDART_INF_F;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          tc::ldsm_x4_t(bv, sv + tc::tile_off(
                                   kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   dp * 16 + (lane >> 4) * 8, PITCH, SWZ));
          tc::mma(acc[2 * dp], pa, bv[0], bv[1]);
          tc::mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                 // this stage is consumed
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // the rows' log-sum-exp in natural units (m is in log2 units of the
  // scaled scores); +inf for a row with no visible key, whose backward
  // probabilities exp(s - lse) are then all 0
  if (lse != nullptr && (lane & 3) == 0) {
    if (r0 < Sq)
      lse[(size_t)bh * Sq + r0] =
          l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : CUDART_INF_F;
    if (r1 < Sq)
      lse[(size_t)bh * Sq + r1] =
          l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : CUDART_INF_F;
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? r1 : r0;
    if (qp >= Sq) continue;
    const float inv = half ? inv1 : inv0;
    bf16* orow = o + ((size_t)b * Sq + qp) * q_row + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float x0 = acc[j][2 * half] * inv;
      const float x1 = acc[j][2 * half + 1] * inv;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = tc::pack_bf16(x0, x1);
      } else {
        if (c < d) orow[c] = __float2bfloat16(x0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
              float* lse, int B, int Sq, int Sk, int H, int K, int d,
              int causal, int window, float scale, void* stream) {
  const size_t smem = tc_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc<DP><<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, o, lse, Sq, Sk, H, K, d, causal, window, scale * kLog2e,
      vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: dQ, dK, dV of o = softmax(mask(q k^T / sqrt(d))) v
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: it is the gradient of the function of the Pallas
// kernel's `_kernel` (src/repro/kernels/flash_attention/kernel.py), which
// the reference's training takes through the jnp attention_blocked
// (src/repro/models/layers.py).  FlashAttention-2's split, each kernel
// recomputing the probabilities from the forward's row log-sum-exp
// (P = exp(S * scale - lse), exactly 0 where masked or where a row sees no
// key, lse = +inf) and D = rowsum(dO o O):
//
//   `flash_bwd_dq`   launched first: D of its rows (written for the next
//                    kernel), then over the key tiles its rows can see,
//                    dS = P o (dP - D) and dQ += dS K; dQ written once.
//   `flash_bwd_dkdv` one block per (batch*kv head, key block): over the
//                    group's H / K query heads and the query tiles that can
//                    see its keys, dV += P^T dO and dK += dS^T Q; each
//                    written once, so GQA's sum over the group is in the
//                    block's registers.
//
// No atomics: every sum has a fixed order and a step repeats its bits.
// The dtype and d pick one of three routes (`bwd_route`; kernel.py's
// `bwd_route` holds the same rule and checks it against this library):
//
//   wgmma    bf16 at d = 64 or 128 (every served arch but zamba2):
//            `flash_bwd_dq_wg<d>` and `flash_bwd_dkdv_wg<d>`, below;
//   mma.sync bf16 at any other d (zamba2's 112): `flash_bwd_dq_tc` and
//            `flash_bwd_dkdv_tc`, 4 warps and 64-row tiles, K/V (or Q/dO)
//            double-buffered by cp.async and read by ldmatrix;
//   scalar   f32: `flash_bwd_dq<float>` and `flash_bwd_dkdv<float>`, four
//            threads a row as in the forward.
//
// Bound on this card: operations.  At qwen3-1.7b's training shape
// (B = 2, S = 4096, H = 16, K = 8, d = 128, causal) the function's least
// work is 2.5x the forward's (S, dP, dV, dQ and dK once), 344 GFLOP, 0.347
// ms at the bf16 peak; the split recomputes S and dP in both kernels, 481
// GFLOP.  Its bytes (q, k, v, o, dO, lse read once, dq, dk, dv written
// once) are about 0.2 GB.  What held the mma.sync pair at 6x its bound,
// and what the wgmma pair does about it:
//
//   * mma.sync m16n8k16 reaches only part of the tensor cores' rate: the
//     products are wgmma m64nNk16, issued by a warpgroup, S^T/dP^T (S/dP)
//     with both operands in shared memory, dV/dK (dQ) with P^T and dS^T
//     (dS) rounded to bf16 in registers as the A operand -- the
//     accumulator's layout is the register-A layout -- and B read through
//     the transpose bit;
//   * 4 warps of 238-246 registers held an SM to 8-16 warps with little
//     latency hidden: a block is two consumer warpgroups (128 keys or
//     queries, 64 each) and a producer warpgroup, setmaxnreg moving the
//     producer's registers to the consumers, one block an SM; the two
//     consumer groups' exp2 and wgmma overlap on the SM;
//   * per-thread cp.async and ldmatrix cost registers and instructions:
//     one producer thread issues TMA box loads into 128B-swizzled tiles,
//     rings of two or three stages with full and empty mbarriers, and
//     wgmma reads the swizzle through its descriptors, so no consumer
//     thread computes an address or touches the tiles;
//   * dkdv re-read the Q and dO tiles of the query tiles that see each
//     64-key tile from L2: a block now owns 128 keys, so each Q/dO tile is
//     fetched once for twice the keys (and dq's K/V tiles once for 128
//     queries);
//   * the split's recomputation (481 against 344 GFLOP) stays: removing it
//     takes dQ's atomic accumulation across key blocks (FlashAttention-3),
//     whose order changes from run to run.
//
// Two more things decide its speed on the card: the probabilities' 2^x by
// the SFU alone (exp2f's slow-case handling cost a fifth of the time) and
// the mask's per-element test only on tiles that cross an edge (evaluated
// on every tile, it cost a third).  Rows and columns past the ends arrive
// from the TMA as zeros.  The operands stay in shared memory: dq's Q and
// dO held in registers across its loop as wgmma's A came out wrong at
// d = 64 (reloaded every tile they were right, and slower).

static_assert(kBQ == kBK, "the scalar backward gives each thread kKeys "
                           "queries or keys of a tile");

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             T* __restrict__ dq, float* __restrict__ Dbuf, int Sq, int Sk,
             int H, int K, int d, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sq = smem;                  // [kBQ][ld]
  float* sdo = sq + kBQ * ld;        // [kBQ][ld]
  float* sk = sdo + kBQ * ld;        // [kBK][ld]
  float* sv = sk + kBK * ld;         // [kBK][ld]
  float* sp = sv + kBK * ld;         // [kBQ][kBK + 1] dS

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int qpos = q0 + row;

  const size_t q_row = (size_t)H * d;
  const size_t kv_row = (size_t)K * d;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
  const T* ob = o + (size_t)b * Sq * q_row + (size_t)h * d;
  const T* dob = dout + (size_t)b * Sq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int s = q0 + r;
    const bool in = s < Sq;
    sq[r * ld + c] = in ? to_f32(qb[(size_t)s * q_row + c]) : 0.f;
    sdo[r * ld + c] = in ? to_f32(dob[(size_t)s * q_row + c]) : 0.f;
  }
  float Dr = 0.f;
  if (qpos < Sq)
    for (int c = sub; c < d; c += 4)
      Dr = fmaf(to_f32(dob[(size_t)qpos * q_row + c]),
                to_f32(ob[(size_t)qpos * q_row + c]), Dr);
  Dr += __shfl_xor_sync(0xffffffffu, Dr, 1);
  Dr += __shfl_xor_sync(0xffffffffu, Dr, 2);
  if (qpos < Sq && sub == 0) Dbuf[(size_t)bh * Sq + qpos] = Dr;
  const float lr = qpos < Sq ? lse[(size_t)bh * Sq + qpos] : CUDART_INF_F;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;

    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int s = k0 + r;
      const bool in = s < Sk;
      sk[r * ld + c] = in ? to_f32(kb[(size_t)s * kv_row + c]) : 0.f;
      sv[r * ld + c] = in ? to_f32(vb[(size_t)s * kv_row + c]) : 0.f;
    }
    __syncthreads();

    // S and dP of this row against keys k0 + sub + 4 * jj
    float s[kKeys], dp[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) s[jj] = dp[jj] = 0.f;
    const float* qr = sq + row * ld;
    const float* dr = sdo + row * ld;
    for (int e = 0; e < d; ++e) {
      const float qe = qr[e], de = dr[e];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        s[jj] = fmaf(qe, sk[(sub + 4 * jj) * ld + e], s[jj]);
        dp[jj] = fmaf(de, sv[(sub + 4 * jj) * ld + e], dp[jj]);
      }
    }
    float* pr = sp + row * (kBK + 1);
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int kpos = k0 + sub + 4 * jj;
      const bool vis = kpos < Sk && (!causal || kpos <= qpos) &&
                       (window <= 0 || kpos > qpos - window);
      const float p = vis ? expf(s[jj] * scale - lr) : 0.f;
      pr[sub + 4 * jj] = p * (dp[jj] - Dr);
    }
    __syncwarp();                    // the row's four threads share pr
    for (int kk = 0; kk < kBK; ++kk) {
      const float ds = pr[kk];
      const float* kr = sk + kk * ld + sub;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (sub + 4 * j < d) acc[j] = fmaf(ds, kr[4 * j], acc[j]);
    }
  }

  if (qpos < Sq) {
    T* drow = dq + ((size_t)b * Sq + qpos) * q_row + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + 4 * j;
      if (c < d) drow[c] = from_f32<T>(acc[j] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ Dbuf, T* __restrict__ dk,
               T* __restrict__ dv, int Sq, int Sk, int H, int K, int d,
               int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sk = smem;                  // [kBK][ld]
  float* sv = sk + kBK * ld;         // [kBK][ld]
  float* sq = sv + kBK * ld;         // [kBQ][ld]
  float* sdo = sq + kBQ * ld;        // [kBQ][ld]
  float* sp = sdo + kBQ * ld;        // [kBK][kBQ + 1] P^T
  float* sds = sp + kBK * (kBQ + 1); // [kBK][kBQ + 1] dS^T
  float* sl = sds + kBK * (kBQ + 1); // [kBQ] lse
  float* sD = sl + kBQ;              // [kBQ] D

  const int bk = blockIdx.y;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int G = H / K;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int row = tid >> 2;          // this thread's key
  const int sub = tid & 3;
  const int kpos = k0 + row;

  const size_t q_row = (size_t)H * d;
  const size_t kv_row = (size_t)K * d;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * d;
  for (int i = tid; i < kBK * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int s = k0 + r;
    const bool in = s < Sk;
    sk[r * ld + c] = in ? to_f32(kb[(size_t)s * kv_row + c]) : 0.f;
    sv[r * ld + c] = in ? to_f32(vb[(size_t)s * kv_row + c]) : 0.f;
  }

  float acck[kCols], accv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acck[j] = accv[j] = 0.f;

  // the query tiles that can see this key tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBK - 1 + window) : Sq;
  const int t_lo = q_lo / kBQ, t_hi = (q_hi + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t bh = (size_t)b * H + h;
    const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
    const T* dob = dout + (size_t)b * Sq * q_row + (size_t)h * d;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();               // the previous tile is consumed
      for (int i = tid; i < kBQ * d; i += kThreads) {
        const int r = i / d, c = i - r * d;
        const int s = q0 + r;
        const bool in = s < Sq;
        sq[r * ld + c] = in ? to_f32(qb[(size_t)s * q_row + c]) : 0.f;
        sdo[r * ld + c] = in ? to_f32(dob[(size_t)s * q_row + c]) : 0.f;
      }
      for (int i = tid; i < kBQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sl[i] = in ? lse[bh * Sq + q0 + i] : CUDART_INF_F;
        sD[i] = in ? Dbuf[bh * Sq + q0 + i] : 0.f;
      }
      __syncthreads();

      // P^T and dP^T of this key against queries q0 + sub + 4 * jj
      float s[kKeys], dp[kKeys];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) s[jj] = dp[jj] = 0.f;
      const float* kr = sk + row * ld;
      const float* vr = sv + row * ld;
      for (int e = 0; e < d; ++e) {
        const float ke = kr[e], ve = vr[e];
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          s[jj] = fmaf(ke, sq[(sub + 4 * jj) * ld + e], s[jj]);
          dp[jj] = fmaf(ve, sdo[(sub + 4 * jj) * ld + e], dp[jj]);
        }
      }
      float* pr = sp + row * (kBQ + 1);
      float* dsr = sds + row * (kBQ + 1);
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int qq = sub + 4 * jj, qpos = q0 + qq;
        const bool vis = qpos < Sq && kpos < Sk &&
                         (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
        const float p = vis ? expf(s[jj] * scale - sl[qq]) : 0.f;
        pr[qq] = p;
        dsr[qq] = p * (dp[jj] - sD[qq]);
      }
      __syncwarp();                  // the key's four threads share pr
      for (int qq = 0; qq < kBQ; ++qq) {
        const float p = pr[qq], ds = dsr[qq];
        const float* dor = sdo + qq * ld + sub;
        const float* qr = sq + qq * ld + sub;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (sub + 4 * j < d) {
            accv[j] = fmaf(p, dor[4 * j], accv[j]);
            acck[j] = fmaf(ds, qr[4 * j], acck[j]);
          }
      }
    }
  }

  if (kpos < Sk) {
    const size_t off = ((size_t)b * Sk + kpos) * kv_row + (size_t)kh * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + 4 * j;
      if (c < d) {
        dk[off + c] = from_f32<T>(acck[j] * scale);
        dv[off + c] = from_f32<T>(accv[j]);
      }
    }
  }
}

size_t bwd_dq_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * (d + 1) +
                          (size_t)kBQ * (kBK + 1));
}

size_t bwd_dkdv_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * (d + 1) +
                          2 * (size_t)kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* Dbuf, int parts, int B, int Sq, int Sk,
               int H, int K, int d, int causal, int window, float scale,
               void* stream) {
  const size_t s_dq = bwd_dq_smem_bytes(d), s_kv = bwd_dkdv_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_kv);
  if (err != cudaSuccess) return (int)err;
  if (parts & 1) {
    flash_bwd_dq<T><<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, s_dq,
                      (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        lse, (T*)dq, Dbuf, Sq, Sk, H, K, d, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2)
    flash_bwd_dkdv<T><<<dim3((Sk + kBK - 1) / kBK, B * K), kThreads, s_kv,
                        (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dbuf,
        (T*)dk, (T*)dv, Sq, Sk, H, K, d, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 backward on the tensor cores.  Shared memory: six [64][pitch] bf16
// tiles (dq: Q, dO and two stages of K and V; dkdv: K, V and two stages of
// Q and dO) and four [64] f32 rows (lse and D).
size_t tc_bwd_smem_bytes(int d) {
  const int dp = (d + 15) / 16 * 16;
  return sizeof(bf16) * 6 * (size_t)kBK * tc::tile_pitch(dp) +
         sizeof(float) * 4 * kBQ;
}

// zero the padding columns [d, DP) of the first `tiles` tiles: no load
// writes them, and a pad must not meet the other operand's zeros as NaN
template <int DP>
__device__ __forceinline__ void zero_pad_columns(bf16* sbuf, int tiles,
                                                 int d) {
  constexpr int PITCH = tc::tile_pitch(DP);
  constexpr int SWZ = tc::tile_swz(DP);
  if (d < DP) {
    const int w = DP - d;
    for (int i = threadIdx.x; i < tiles * kBK * w; i += kTcThreads) {
      const int r = i / w, c = d + (i - r * w);
      sbuf[(r / kBK) * kBK * PITCH + tc::tile_off(r % kBK, c, PITCH, SWZ)] =
          __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ dq,
                float* __restrict__ Dbuf, int Sq, int Sk, int H, int K,
                int d, int causal, int window, float scale_log2,
                float scale, int vec) {
  constexpr int KS = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int NT = kBK / 8;
  constexpr int PITCH = tc::tile_pitch(DP);
  constexpr int SWZ = tc::tile_swz(DP);
  constexpr int TILE = kBK * PITCH;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* const sbuf = reinterpret_cast<bf16*>(fa_smem);
  bf16* const sQ = sbuf;             // then dO at + TILE; stage s of K at
  bf16* const sdO = sbuf + TILE;     // + (2 + 2 s) TILE, V after it
  float* const sl = reinterpret_cast<float*>(sbuf + 6 * TILE);
  float* const sD = sl + kBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * d, kv_row = (size_t)K * d;
  const size_t q_base = (size_t)b * Sq * q_row + (size_t)h * d;
  const bf16* kb = k + (size_t)b * Sk * kv_row + (size_t)kh * d;
  const bf16* vb = v + (size_t)b * Sk * kv_row + (size_t)kh * d;

  zero_pad_columns<DP>(sbuf, 6, d);

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int t_end = (Sk + kBK - 1) / kBK;
  if (causal) t_end = min(t_end, q_last / kBK + 1);
  int t_begin = 0;
  if (window > 0 && q0 - window - (kBK - 1) >= 0)
    t_begin = (q0 - window - (kBK - 1)) / kBK + 1;

  load_tile(sQ, q + q_base, q_row, q0, Sq, d, PITCH, SWZ, vec);
  load_tile(sdO, dout + q_base, q_row, q0, Sq, d, PITCH, SWZ, vec);
  if (t_begin < t_end) {
    load_tile(sbuf + 2 * TILE, kb, kv_row, t_begin * kBK, Sk, d, PITCH, SWZ,
              vec);
    load_tile(sbuf + 3 * TILE, vb, kv_row, t_begin * kBK, Sk, d, PITCH, SWZ,
              vec);
  }
  tc::cp_async_commit();
  {                                  // D and lse of the block's rows
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < Sq) {
      const bf16* orow = o + q_base + (size_t)qp * q_row;
      const bf16* drow = dout + q_base + (size_t)qp * q_row;
      for (int c = half; c < d; c += 2)
        acc = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sD[r] = acc;
      sl[r] = qp < Sq ? lse[(size_t)bh * Sq + qp] * kLog2e : CUDART_INF_F;
      if (qp < Sq) Dbuf[(size_t)bh * Sq + qp] = acc;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int l0r = warp * 16 + (lane >> 2), l1r = l0r + 8;
  const float lse0 = sl[l0r], lse1 = sl[l1r];
  const float D0 = sD[l0r], D1 = sD[l1r];
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int w_first = q0 + warp * 16, w_last = w_first + 15;
  const int r0 = q0 + l0r, r1 = q0 + l1r;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {             // prefetch the next K/V tile
      bf16* nk = sbuf + (2 + 2 * (st ^ 1)) * TILE;
      load_tile(nk, kb, kv_row, (t + 1) * kBK, Sk, d, PITCH, SWZ, vec);
      load_tile(nk + TILE, vb, kv_row, (t + 1) * kBK, Sk, d, PITCH, SWZ,
                vec);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sbuf + (2 + 2 * st) * TILE;
    const bf16* sv = sk + TILE;
    const int k0 = t * kBK;
    const bool skip = (causal && k0 > w_last) ||
                      (window > 0 && k0 + kBK - 1 <= w_first - window);
    if (!skip) {                     // warp-uniform
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], da[4];
        const int off = tc::tile_off(warp * 16 + (lane & 15),
                                     ks * 16 + (lane >> 4) * 8, PITCH, SWZ);
        tc::ldsm_x4(qa, sQ + off);
        tc::ldsm_x4(da, sdO + off);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int boff = tc::tile_off(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                        ks * 16 + ((lane >> 3) & 1) * 8,
                                        PITCH, SWZ);
          uint32_t bk[4], bv[4];
          tc::ldsm_x4(bk, sk + boff);
          tc::ldsm_x4(bv, sv + boff);
          tc::mma(s[2 * np], qa, bk[0], bk[1]);
          tc::mma(s[2 * np + 1], qa, bk[2], bk[3]);
          tc::mma(dp[2 * np], da, bv[0], bv[1]);
          tc::mma(dp[2 * np + 1], da, bv[2], bv[3]);
        }
      }
      const bool full = k0 + kBK <= Sk &&
                        (!causal || k0 + kBK - 1 <= w_first) &&
                        (window <= 0 || k0 > w_last - window);
      // dS = P o (dP - D), in s
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = e < 2 ? r0 : r1;
          const bool vis = full || (kp < Sk && (!causal || kp <= qp) &&
                                    (window <= 0 || kp > qp - window));
          const float p =
              vis ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? D0 : D1));
        }
      }
      // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t bk[4];
          tc::ldsm_x4_t(bk, sk + tc::tile_off(
                                   kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   dp2 * 16 + (lane >> 4) * 8, PITCH, SWZ));
          tc::mma(acc[2 * dp2], pa, bk[0], bk[1]);
          tc::mma(acc[2 * dp2 + 1], pa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                 // this stage is consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? r1 : r0;
    if (qp >= Sq) continue;
    bf16* drow = dq + q_base + (size_t)qp * q_row;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float x0 = acc[j][2 * half] * scale;
      const float x1 = acc[j][2 * half + 1] * scale;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(drow + c) = tc::pack_bf16(x0, x1);
      } else {
        if (c < d) drow[c] = __float2bfloat16(x0);
        if (c + 1 < d) drow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

constexpr int kHalfQ = 32;           // queries a dkdv sub-step

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ Dbuf, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, int H, int K, int d,
                  int causal, int window, float scale_log2, float scale,
                  int vec) {
  constexpr int KS = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int NH = kHalfQ / 8;     // n8-tiles of a sub-step's S^T
  constexpr int PITCH = tc::tile_pitch(DP);
  constexpr int SWZ = tc::tile_swz(DP);
  constexpr int TILE = kBK * PITCH;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* const sbuf = reinterpret_cast<bf16*>(fa_smem);
  bf16* const sK = sbuf;             // then V; stage s of Q at
  bf16* const sV = sbuf + TILE;      // + (2 + 2 s) TILE, dO after it
  float* const sl = reinterpret_cast<float*>(sbuf + 6 * TILE);   // [2][64]
  float* const sD = sl + 2 * kBQ;                                // [2][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * kBK;   // the first key tiles see the most
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int G = H / K;
  const size_t q_row = (size_t)H * d, kv_row = (size_t)K * d;
  const size_t kv_base = (size_t)b * Sk * kv_row + (size_t)kh * d;

  zero_pad_columns<DP>(sbuf, 6, d);

  // the query tiles that can see this key tile, for each of the group's
  // heads: iteration it is head kh * G + it / nt, tile t_lo + it % nt
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBK - 1 + window) : Sq;
  const int t_lo = q_lo / kBQ;
  const int nt = max(0, (q_hi + kBQ - 1) / kBQ - t_lo);
  const int n_it = G * nt;
  auto load_stage = [&](int it, int stage) {
    const int h = kh * G + it / nt, q0 = (t_lo + it % nt) * kBQ;
    const size_t bh = (size_t)b * H + h;
    const size_t q_base = (size_t)b * Sq * q_row + (size_t)h * d;
    bf16* dst = sbuf + (2 + 2 * stage) * TILE;
    load_tile(dst, q + q_base, q_row, q0, Sq, d, PITCH, SWZ, vec);
    load_tile(dst + TILE, dout + q_base, q_row, q0, Sq, d, PITCH, SWZ, vec);
    for (int i = threadIdx.x; i < kBQ; i += kTcThreads) {
      const bool in = q0 + i < Sq;
      tc::cp_async4(sl + stage * kBQ + i, in ? lse + bh * Sq + q0 + i : lse,
                    in ? 4 : 0);
      tc::cp_async4(sD + stage * kBQ + i, in ? Dbuf + bh * Sq + q0 + i : Dbuf,
                    in ? 4 : 0);
    }
  };

  load_tile(sK, k + kv_base, kv_row, k0, Sk, d, PITCH, SWZ, vec);
  load_tile(sV, v + kv_base, kv_row, k0, Sk, d, PITCH, SWZ, vec);
  if (n_it > 0) load_stage(0, 0);
  tc::cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int kw_first = k0 + warp * 16, kw_last = kw_first + 15;
  const int kr0 = kw_first + (lane >> 2), kr1 = kr0 + 8;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {             // prefetch the next Q/dO tile
      load_stage(it + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = sbuf + (2 + 2 * st) * TILE;
    const bf16* sdO = sQ + TILE;
    const float* slse = sl + st * kBQ;
    const float* sDD = sD + st * kBQ;
    const int q0 = (t_lo + it % nt) * kBQ;
#pragma unroll 1
    for (int hq = 0; hq < kBQ / kHalfQ; ++hq) {
      const int qf = q0 + hq * kHalfQ, ql = qf + kHalfQ - 1;
      const bool skip = qf >= Sq || (causal && ql < kw_first) ||
                        (window > 0 && kw_last <= qf - window);
      if (skip) continue;            // warp-uniform
      const bool full = ql < Sq && kw_last < Sk &&
                        (!causal || qf >= kw_last) &&
                        (window <= 0 || kw_first > ql - window);
      // S^T = K Q^T: this warp's 16 keys against the sub-step's queries
      float sT[NH][4], dpT[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        const int off = tc::tile_off(warp * 16 + (lane & 15),
                                     ks * 16 + (lane >> 4) * 8, PITCH, SWZ);
        tc::ldsm_x4(ka, sK + off);
        tc::ldsm_x4(va, sV + off);
#pragma unroll
        for (int np = 0; np < NH / 2; ++np) {
          const int boff = tc::tile_off(
              hq * kHalfQ + np * 16 + (lane & 7) + (lane >> 4) * 8,
              ks * 16 + ((lane >> 3) & 1) * 8, PITCH, SWZ);
          uint32_t bq[4], bo[4];
          tc::ldsm_x4(bq, sQ + boff);
          tc::ldsm_x4(bo, sdO + boff);
          tc::mma(sT[2 * np], ka, bq[0], bq[1]);
          tc::mma(sT[2 * np + 1], ka, bq[2], bq[3]);
          tc::mma(dpT[2 * np], va, bo[0], bo[1]);
          tc::mma(dpT[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      // P^T in sT, dS^T = P^T o (dP^T - D) in dpT
#pragma unroll
      for (int j = 0; j < NH; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql_i = hq * kHalfQ + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = q0 + ql_i;
          const int kp = e < 2 ? kr0 : kr1;
          const bool vis = full || (qp < Sq && kp < Sk &&
                                    (!causal || kp <= qp) &&
                                    (window <= 0 || kp > qp - window));
          const float p =
              vis ? exp2f(sT[j][e] * scale_log2 - slse[ql_i] * kLog2e) : 0.f;
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - sDD[ql_i]);
        }
      }
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
      // registers (the sub-step's queries are the k dimension)
#pragma unroll
      for (int kk = 0; kk < kHalfQ / 16; ++kk) {
        const uint32_t pa[4] = {
            tc::pack_bf16(sT[2 * kk][0], sT[2 * kk][1]),
            tc::pack_bf16(sT[2 * kk][2], sT[2 * kk][3]),
            tc::pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]),
            tc::pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            tc::pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]),
            tc::pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]),
            tc::pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]),
            tc::pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          const int boff = tc::tile_off(
              hq * kHalfQ + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
              dp2 * 16 + (lane >> 4) * 8, PITCH, SWZ);
          uint32_t bo[4], bq[4];
          tc::ldsm_x4_t(bo, sdO + boff);
          tc::ldsm_x4_t(bq, sQ + boff);
          tc::mma(dva[2 * dp2], pa, bo[0], bo[1]);
          tc::mma(dva[2 * dp2 + 1], pa, bo[2], bo[3]);
          tc::mma(dka[2 * dp2], sa, bq[0], bq[1]);
          tc::mma(dka[2 * dp2 + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                 // this stage is consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kr1 : kr0;
    if (kp >= Sk) continue;
    bf16* krow = dk + kv_base + (size_t)kp * kv_row;
    bf16* vrow = dv + kv_base + (size_t)kp * kv_row;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float k0v = dka[j][2 * half] * scale;
      const float k1v = dka[j][2 * half + 1] * scale;
      const float v0v = dva[j][2 * half], v1v = dva[j][2 * half + 1];
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(krow + c) = tc::pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(vrow + c) = tc::pack_bf16(v0v, v1v);
      } else {
        if (c < d) {
          krow[c] = __float2bfloat16(k0v);
          vrow[c] = __float2bfloat16(v0v);
        }
        if (c + 1 < d) {
          krow[c + 1] = __float2bfloat16(k1v);
          vrow[c + 1] = __float2bfloat16(v1v);
        }
      }
    }
  }
}

template <int DP>
int launch_bwd_tc(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* o, const bf16* dout, const float* lse,
                  bf16* dq, bf16* dk, bf16* dv, float* Dbuf, int parts,
                  int B, int Sq, int Sk, int H, int K, int d, int causal,
                  int window, float scale, void* stream) {
  const size_t smem = tc_bwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)dout) % 16 == 0;
  if (parts & 1) {
    flash_bwd_dq_tc<DP><<<dim3(B * H, (Sq + kBQ - 1) / kBQ), kTcThreads,
                          smem, (cudaStream_t)stream>>>(
        q, k, v, o, dout, lse, dq, Dbuf, Sq, Sk, H, K, d, causal, window,
        scale * kLog2e, scale, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2)
    flash_bwd_dkdv_tc<DP><<<dim3(B * K, (Sk + kBK - 1) / kBK), kTcThreads,
                            smem, (cudaStream_t)stream>>>(
        q, k, v, dout, lse, Dbuf, dk, dv, Sq, Sk, H, K, d, causal, window,
        scale * kLog2e, scale, vec);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at d = 64 and d = 128: wgmma fed by TMA rings, warp-specialised
// ---------------------------------------------------------------------------
//
// Every tile is [64 rows][DP] bf16 in DP / 64 boxes of [64][64], each 8 KB
// and 128B-swizzled by the TMA (hopper_tma_wgmma.cuh); a 128-row operand is
// two such tiles, one for each consumer warpgroup.  A block has 384
// threads: consumer warpgroups 0 and 1 (setmaxnreg up to kWgConsumerRegs)
// and producer warpgroup 2 (down to kWgProducerRegs), whose first warp
// alone issues the copies.  The ring's `full` barrier completes when a
// stage's bytes have landed, its `empty` barrier when each of the eight
// consumer warps has finished with it.

constexpr int kWgThreads = 384;
constexpr int kWgConsumerThreads = 256;
constexpr int kWgRows = 64;            // rows (queries or keys) of a tile
constexpr int kDqStages = 3;           // ring depth: K and V tiles
constexpr int kDkdvStages = 2;         // ring depth: Q and dO tiles
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;   // 2x128x232 + 128x40 = 384 x 168

__host__ __device__ constexpr int wg_tile_bytes(int DP) {
  return DP / 64 * hop::kBox64Bytes;
}

// Dynamic shared memory of the two kernels (1024 bytes of slack align the
// base): dq holds Q and dO of 128 rows, a ring of K and V tiles, D of its
// rows and 2 kDqStages + 1 barriers; dkdv holds K and V of 128 keys, a
// ring of Q and dO tiles with their lse and D rows, and its barriers.
size_t wg_dq_smem_bytes(int DP) {
  return 1024 + (size_t)(4 + 2 * kDqStages) * wg_tile_bytes(DP) +
         sizeof(float) * 2 * kWgRows + 8 * (2 * kDqStages + 1);
}
size_t wg_dkdv_smem_bytes(int DP) {
  return 1024 + (size_t)(4 + 2 * kDkdvStages) * wg_tile_bytes(DP) +
         sizeof(float) * 2 * kDkdvStages * kWgRows +
         8 * (2 * kDkdvStages + 1);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = hop::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// a tile's TMA loads: DP / 64 boxes of rows [s0, s0 + 64) of one head
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int head, int s0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    hop::tma_load_4d(dst + c * hop::kBox64Bytes, map, bar, c * 64, head, s0,
                     b);
}

// acc[32] (+)= A B^T over the DP columns: A and B are [64][DP] tiles, the
// 64 x 64 product accumulated over DP / 16 k-steps of 32 bytes each
template <int DP>
__device__ __forceinline__ void wg_product_abt(float (&acc)[32],
                                               const unsigned char* a,
                                               const unsigned char* b) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int off = (ks >> 2) * hop::kBox64Bytes + (ks & 3) * 32;
    hop::wgmma_ss(acc, hop::desc_k_sw128(a + off), hop::desc_k_sw128(b + off),
                  ks > 0);
  }
}

// acc[DP / 2] += A B: A [64 x 64] in registers (a[kk] the k-step's
// fragment), B a [64][DP] tile whose rows are the k dimension
template <int DP>
__device__ __forceinline__ void wg_product_ab(float (&acc)[DP / 2],
                                              const uint32_t (&a)[4][4],
                                              const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_rs(acc, a[kk],
                  hop::desc_mn_sw128(b + kk * 16 * 128, hop::kBox64Bytes), 1);
}

// The A fragments of a 64 x 64 accumulator, rounded to bf16: k-step kk is
// its n8 blocks 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = tc::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// rows r0 (registers e < 2) and r0 + 8 (e >= 2) of a [64 x DP] f32
// accumulator, times `mul`, rounded to bf16 into [., d] rows of `out`
// (row stride `stride` elements); rows at or past `rows` are skipped
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride,
                                           const float (&acc)[DP / 2],
                                           int r0, int rows, float mul,
                                           int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    bf16* row = out + (size_t)r * stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8 + (lane & 3) * 2) =
          tc::pack_bf16(acc[4 * j + 2 * half] * mul,
                        acc[4 * j + 2 * half + 1] * mul);
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: about 2 ulp, subnormal results
// flushed to 0, exp2(-inf) = 0), without exp2f's slow-case handling
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>   // 64 or 128 (== d)
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ dq,
                float* __restrict__ Dbuf, int Sq, int Sk, int H, int K,
                int causal, int window, float scale_log2, float scale) {
  constexpr int TILE = wg_tile_bytes(DP);
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* const smem = align_1024(wg_smem_raw);
  unsigned char* const sQ = smem;                // [2] tiles: rows 0-63, 64-127
  unsigned char* const sdO = smem + 2 * TILE;    // [2] tiles
  unsigned char* const ring = smem + 4 * TILE;   // stage s: K, then V
  float* const sD = reinterpret_cast<float*>(ring + 2 * kDqStages * TILE);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sD + 2 * kWgRows);
  uint64_t* const empty = full + kDqStages;
  uint64_t* const qdo_bar = empty + kDqStages;

  // grid (B*H, query blocks of 128): the last, longest under a causal
  // mask, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kWgRows;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int d = DP;
  // the key tiles some row of the block can see
  const int q_last = min(q0 + 2 * kWgRows, Sq) - 1;
  int t_end = (Sk + kWgRows - 1) / kWgRows;
  if (causal) t_end = min(t_end, q_last / kWgRows + 1);
  int t_begin = 0;
  if (window > 0 && q0 - window - (kWgRows - 1) >= 0)
    t_begin = (q0 - window - (kWgRows - 1)) / kWgRows + 1;
  const int n_t = max(0, t_end - t_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kWgConsumerThreads / 32);
    }
    hop::mbar_init(qdo_bar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumerThreads) {
    // producer: Q and dO once, then the ring of K and V tiles
    hop::regs_dealloc<kWgProducerRegs>();
    if (threadIdx.x == kWgConsumerThreads && n_t > 0) {
      hop::mbar_arrive_expect_tx(qdo_bar, 4 * TILE);
      for (int r = 0; r < 2; ++r) {
        tma_tile<DP>(sQ + r * TILE, &tm_q, qdo_bar, h, q0 + r * kWgRows, b);
        tma_tile<DP>(sdO + r * TILE, &tm_do, qdo_bar, h, q0 + r * kWgRows,
                     b);
      }
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kDqStages;
        hop::mbar_wait(&empty[s], ((i / kDqStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&full[s], 2 * TILE);
        const int k0 = (t_begin + i) * kWgRows;
        unsigned char* dst = ring + 2 * s * TILE;
        tma_tile<DP>(dst, &tm_k, &full[s], kh, k0, b);
        tma_tile<DP>(dst + TILE, &tm_v, &full[s], kh, k0, b);
      }
    }
  } else {
    hop::regs_alloc<kWgConsumerRegs>();
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const size_t q_row = (size_t)H * d;
    const size_t q_base = (size_t)b * Sq * q_row + (size_t)h * d;
    {  // D = rowsum(dO o O) of the block's 128 rows, two threads a row
      const int r = tid >> 1, half = tid & 1, qp = q0 + r;
      float acc = 0.f;
      if (qp < Sq) {
        const bf16* orow = o + q_base + (size_t)qp * q_row + half * (d / 2);
        const bf16* drow =
            dout + q_base + (size_t)qp * q_row + half * (d / 2);
#pragma unroll
        for (int c = 0; c < DP / 2; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 of = __bfloat1622float2(o2[i]);
            const float2 df = __bfloat1622float2(d2[i]);
            acc = fmaf(df.x, of.x, acc);
            acc = fmaf(df.y, of.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        sD[r] = acc;
        if (qp < Sq) Dbuf[(size_t)bh * Sq + qp] = acc;
      }
    }
    hop::named_bar_sync(1, kWgConsumerThreads);

    const int w_first = q0 + wg * kWgRows, w_last = w_first + kWgRows - 1;
    const int l0 = wg * kWgRows + warp * 16 + (lane >> 2);  // block row
    const int r0 = q0 + l0, r1 = r0 + 8;
    const float lse0 =
        r0 < Sq ? lse[(size_t)bh * Sq + r0] * kLog2e : CUDART_INF_F;
    const float lse1 =
        r1 < Sq ? lse[(size_t)bh * Sq + r1] * kLog2e : CUDART_INF_F;
    const float D0 = sD[l0], D1 = sD[l0 + 8];
    const unsigned char* const myQ = sQ + wg * TILE;
    const unsigned char* const mydO = sdO + wg * TILE;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    if (n_t > 0) hop::mbar_wait(qdo_bar, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kDqStages;
      hop::mbar_wait(&full[s], (i / kDqStages) & 1);
      const unsigned char* sk = ring + 2 * s * TILE;
      const unsigned char* sv = sk + TILE;
      const int k0 = (t_begin + i) * kWgRows;
      const bool skip = w_first >= Sq || (causal && k0 > w_last) ||
                        (window > 0 && k0 + kWgRows - 1 <= w_first - window);
      if (!skip) {                     // uniform over the warpgroup
        float sacc[32], pacc[32];
        hop::wgmma_fence();
        wg_product_abt<DP>(sacc, myQ, sk);     // S = Q K^T
        hop::wgmma_commit();
        wg_product_abt<DP>(pacc, mydO, sv);    // dP = dO V^T
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        hop::fence_regs(sacc);
        const bool all = k0 + kWgRows <= Sk &&
                         (!causal || k0 + kWgRows - 1 <= w_first) &&
                         (window <= 0 || k0 > w_last - window);
        // P: the mask's test only on tiles that cross an edge
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[4 * j + e] = exp2_sfu(sacc[4 * j + e] * scale_log2 -
                                       (e < 2 ? lse0 : lse1));
        if (!all) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
              const int qp = e < 2 ? r0 : r1;
              if (kp >= Sk || (causal && kp > qp) ||
                  (window > 0 && kp <= qp - window))
                sacc[4 * j + e] = 0.f;
            }
          }
        }
        hop::wgmma_wait<0>();
        hop::fence_regs(pacc);
        // dS = P o (dP - D), rounded to bf16 as dQ's A operand
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[4 * j + e] *= pacc[4 * j + e] - (e < 2 ? D0 : D1);
        uint32_t ds[4][4];
        pack_a(ds, sacc);
        hop::wgmma_fence();
        wg_product_ab<DP>(acc, ds, sk);        // dQ += dS K
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    store_rows<DP>(dq + q_base, q_row, acc, r0, Sq, scale, lane);
  }
}

template <int DP>   // 64 or 128 (== d)
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ Dbuf, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, int H, int K,
                  int causal, int window, float scale_log2, float scale) {
  constexpr int TILE = wg_tile_bytes(DP);
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* const smem = align_1024(wg_smem_raw);
  unsigned char* const sK = smem;                // [2] tiles: keys 0-63, 64-127
  unsigned char* const sV = smem + 2 * TILE;     // [2] tiles
  unsigned char* const ring = smem + 4 * TILE;   // stage s: Q, then dO
  float* const sl = reinterpret_cast<float*>(ring + 2 * kDkdvStages * TILE);
  float* const sD = sl + kDkdvStages * kWgRows;    // [stage][64] each
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(sD + kDkdvStages * kWgRows);
  uint64_t* const empty = full + kDkdvStages;
  uint64_t* const kv_bar = empty + kDkdvStages;

  // grid (B*K, key blocks of 128): the first, which the most queries see
  // under a causal mask, first
  const int k0 = blockIdx.y * 2 * kWgRows;
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int G = H / K;
  const int d = DP;
  // the query tiles that can see some key of the block, for each of the
  // group's heads: iteration it is head kh * G + it / nt, tile t_lo + it % nt
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + 2 * kWgRows - 1 + window) : Sq;
  const int t_lo = q_lo / kWgRows;
  const int nt = max(0, (q_hi + kWgRows - 1) / kWgRows - t_lo);
  const int n_it = G * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkdvStages; ++s) {
      hop::mbar_init(&full[s], 32);    // the producer warp's lanes
      hop::mbar_init(&empty[s], kWgConsumerThreads / 32);
    }
    hop::mbar_init(kv_bar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumerThreads) {
    // producer warp: K and V once, then the ring of Q and dO tiles; its
    // lanes bring each tile's lse (in log2 units) and D rows
    hop::regs_dealloc<kWgProducerRegs>();
    if (threadIdx.x < kWgConsumerThreads + 32 && n_it > 0) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hop::mbar_arrive_expect_tx(kv_bar, 4 * TILE);
        for (int r = 0; r < 2; ++r) {
          tma_tile<DP>(sK + r * TILE, &tm_k, kv_bar, kh, k0 + r * kWgRows,
                       b);
          tma_tile<DP>(sV + r * TILE, &tm_v, kv_bar, kh, k0 + r * kWgRows,
                       b);
        }
      }
      // rows lane and lane + 32 of iteration it's lse and D, loaded one
      // iteration ahead
      auto rows = [&](int it, float (&l)[2], float (&dd)[2]) {
        const int h = kh * G + it / nt, q0 = (t_lo + it % nt) * kWgRows;
        const size_t bh = (size_t)b * H + h;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qp = q0 + lane + 32 * i;
          l[i] = qp < Sq ? lse[bh * Sq + qp] * kLog2e : CUDART_INF_F;
          dd[i] = qp < Sq ? Dbuf[bh * Sq + qp] : 0.f;
        }
      };
      float l_next[2], d_next[2];
      rows(0, l_next, d_next);
      for (int it = 0; it < n_it; ++it) {
        const float l_cur[2] = {l_next[0], l_next[1]};
        const float d_cur[2] = {d_next[0], d_next[1]};
        if (it + 1 < n_it) rows(it + 1, l_next, d_next);
        const int s = it % kDkdvStages;
        hop::mbar_wait(&empty[s], ((it / kDkdvStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sl[s * kWgRows + lane + 32 * i] = l_cur[i];
          sD[s * kWgRows + lane + 32 * i] = d_cur[i];
        }
        if (lane == 0) {
          const int h = kh * G + it / nt, q0 = (t_lo + it % nt) * kWgRows;
          hop::mbar_arrive_expect_tx(&full[s], 2 * TILE);
          unsigned char* dst = ring + 2 * s * TILE;
          tma_tile<DP>(dst, &tm_q, &full[s], h, q0, b);
          tma_tile<DP>(dst + TILE, &tm_do, &full[s], h, q0, b);
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    hop::regs_alloc<kWgConsumerRegs>();
    const int tid = threadIdx.x;
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int kw_first = k0 + wg * kWgRows, kw_last = kw_first + kWgRows - 1;
    const int kr0 = kw_first + warp * 16 + (lane >> 2), kr1 = kr0 + 8;
    const unsigned char* const myK = sK + wg * TILE;
    const unsigned char* const myV = sV + wg * TILE;

    float dka[DP / 2], dva[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
    if (n_it > 0) hop::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kDkdvStages;
      hop::mbar_wait(&full[s], (it / kDkdvStages) & 1);
      const int q0 = (t_lo + it % nt) * kWgRows, ql = q0 + kWgRows - 1;
      const bool skip = kw_first >= Sk || q0 >= Sq ||
                        (causal && ql < kw_first) ||
                        (window > 0 && kw_last <= q0 - window);
      if (!skip) {                     // uniform over the warpgroup
        const unsigned char* sq = ring + 2 * s * TILE;
        const unsigned char* sdo = sq + TILE;
        const float* slse = sl + s * kWgRows;
        const float* sDD = sD + s * kWgRows;
        float st[32], dpt[32];
        hop::wgmma_fence();
        wg_product_abt<DP>(st, myK, sq);       // S^T = K Q^T
        hop::wgmma_commit();
        wg_product_abt<DP>(dpt, myV, sdo);     // dP^T = V dO^T
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        hop::fence_regs(st);
        const bool all = ql < Sq && kw_last < Sk &&
                         (!causal || q0 >= kw_last) &&
                         (window <= 0 || kw_first > ql - window);
        // P^T, keys the rows and queries the columns: the mask's test
        // only on tiles that cross an edge
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * j + e] = exp2_sfu(st[4 * j + e] * scale_log2 -
                                     slse[j * 8 + (lane & 3) * 2 + (e & 1)]);
        if (!all) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = q0 + j * 8 + (lane & 3) * 2 + (e & 1);
              const int kp = e < 2 ? kr0 : kr1;
              if (qp >= Sq || kp >= Sk || (causal && kp > qp) ||
                  (window > 0 && kp <= qp - window))
                st[4 * j + e] = 0.f;
            }
          }
        }
        hop::wgmma_wait<0>();
        hop::fence_regs(dpt);
        // dS^T = P^T o (dP^T - D)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] *
                             (dpt[4 * j + e] - sDD[j * 8 + (lane & 3) * 2 +
                                                   (e & 1)]);
        uint32_t pa[4][4], sa[4][4];
        pack_a(pa, st);
        pack_a(sa, dpt);
        hop::wgmma_fence();
        wg_product_ab<DP>(dva, pa, sdo);       // dV += P^T dO
        wg_product_ab<DP>(dka, sa, sq);        // dK += dS^T Q
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(dva);
        hop::fence_regs(dka);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    const size_t kv_row = (size_t)K * d;
    const size_t kv_base = (size_t)b * Sk * kv_row + (size_t)kh * d;
    store_rows<DP>(dk + kv_base, kv_row, dka, kr0, Sk, scale, lane);
    store_rows<DP>(dv + kv_base, kv_row, dva, kr0, Sk, 1.f, lane);
  }
}

template <int DP>
int launch_bwd_wg(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* o, const bf16* dout, const float* lse,
                  bf16* dq, bf16* dk, bf16* dv, float* Dbuf, int parts,
                  int B, int Sq, int Sk, int H, int K, int causal,
                  int window, float scale, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) %
      16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  int err = hop_host::bshd_map(&tq, q, B, Sq, H, DP, kWgRows);
  if (!err) err = hop_host::bshd_map(&tk, k, B, Sk, K, DP, kWgRows);
  if (!err) err = hop_host::bshd_map(&tv, v, B, Sk, K, DP, kWgRows);
  if (!err) err = hop_host::bshd_map(&tdo, dout, B, Sq, H, DP, kWgRows);
  if (err) return err;
  const size_t s_dq = wg_dq_smem_bytes(DP), s_kv = wg_dkdv_smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wg<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wg<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s_kv);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  if (parts & 1) {
    flash_bwd_dq_wg<DP><<<dim3(B * H, (Sq + 2 * kWgRows - 1) / (2 * kWgRows)),
                          kWgThreads, s_dq, (cudaStream_t)stream>>>(
        tq, tk, tv, tdo, o, dout, lse, dq, Dbuf, Sq, Sk, H, K, causal, window,
        scale_log2, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (parts & 2)
    flash_bwd_dkdv_wg<DP>
        <<<dim3(B * K, (Sk + 2 * kWgRows - 1) / (2 * kWgRows)), kWgThreads,
           s_kv, (cudaStream_t)stream>>>(tq, tk, tv, tdo, lse, Dbuf, dk, dv,
                                         Sq, Sk, H, K, causal, window,
                                         scale_log2, scale);
  return (int)cudaGetLastError();
}

// The backward's routes; kernel.py's `bwd_route` holds the same rule.
enum BwdRoute { kRouteScalar = 0, kRouteMmaSync = 1, kRouteWgmma = 2 };

int bwd_route(int dtype, int d) {
  if (d < 1 || d > kMaxD) return -1;
  if (dtype == 0) return kRouteScalar;
  return d == 64 || d == 128 ? kRouteWgmma : kRouteMmaSync;
}
}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// q/o: [B, Sq, H, d]; k/v: [B, Sk, K, d], all contiguous; H % K == 0;
// 1 <= d <= 128; scale = 1 / sqrt(d).  lse: null, or f32 [B, H, Sq] that
// receives each row's log-sum-exp of the scaled, masked scores (+inf for a
// row with no visible key); o's bits do not depend on it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype, int B, int Sq, int Sk,
                                      int H, int K, int d, int causal,
                                      int window, float scale,
                                      void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, B, Sq, Sk, H, K, d, causal,
                         window, scale, stream);
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  switch ((d + 15) / 16) {
#define FA_TC_CASE(n)                                                       \
  case n:                                                                   \
    return launch_tc<16 * n>(qb, kb, vb, ob, lse, B, Sq, Sk, H, K, d,       \
                             causal, window, scale, stream);
    FA_TC_CASE(1)
    FA_TC_CASE(2)
    FA_TC_CASE(3)
    FA_TC_CASE(4)
    FA_TC_CASE(5)
    FA_TC_CASE(6)
    FA_TC_CASE(7)
    FA_TC_CASE(8)
#undef FA_TC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward: dq [B, Sq, H, d] and dk/dv [B, Sk, K, d] in the dtype of
// q, from q, k, v, the forward's o and lse, and dout (dL/do, the layout of
// o); D is f32 scratch [B, H, Sq] (rowsum(dout o o), written by the first
// kernel, read by the second).  Launches flash_bwd_dq (parts bit 0), then
// flash_bwd_dkdv (bit 1), on `stream`; training passes 3, a timing of one
// kernel alone 1 or 2 (2 after a call that filled D).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* D, int dtype, int parts, int B, int Sq, int Sk, int H, int K,
    int d, int causal, int window, float scale, void* stream) {
  const int route = bwd_route(dtype, d);
  if (route == kRouteScalar)
    return launch_bwd<float>(q, k, v, o, dout, lse, dq, dk, dv, D, parts, B,
                             Sq, Sk, H, K, d, causal, window, scale,
                             stream);
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *ob = (const bf16*)o, *dob = (const bf16*)dout;
  bf16 *dqb = (bf16*)dq, *dkb = (bf16*)dk, *dvb = (bf16*)dv;
  if (route == kRouteWgmma)
    return d == 64 ? launch_bwd_wg<64>(qb, kb, vb, ob, dob, lse, dqb, dkb,
                                       dvb, D, parts, B, Sq, Sk, H, K,
                                       causal, window, scale, stream)
                   : launch_bwd_wg<128>(qb, kb, vb, ob, dob, lse, dqb, dkb,
                                        dvb, D, parts, B, Sq, Sk, H, K,
                                        causal, window, scale, stream);
  switch ((d + 15) / 16) {
#define FA_BWD_CASE(n)                                                      \
  case n:                                                                   \
    return launch_bwd_tc<16 * n>(qb, kb, vb, ob, dob, lse, dqb, dkb, dvb, D, \
                                 parts, B, Sq, Sk, H, K, d, causal, window,  \
                                 scale, stream);
    FA_BWD_CASE(1)
    FA_BWD_CASE(2)
    FA_BWD_CASE(3)
    FA_BWD_CASE(4)
    FA_BWD_CASE(5)
    FA_BWD_CASE(6)
    FA_BWD_CASE(7)
    FA_BWD_CASE(8)
#undef FA_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward's route for a dtype (0 f32, 1 bf16) and head dim: 0 the
// scalar pair, 1 the mma.sync pair, 2 the wgmma pair; -1 for a d outside
// 1..128.
extern "C" int flash_attention_bwd_route(int dtype, int d) {
  return bwd_route(dtype, d);
}

// Dynamic shared memory of the backward's first (kernel 0, dq) or second
// (kernel 1, dkdv) kernel on the route of (dtype, d); 0 for no route.
extern "C" long long flash_attention_bwd_smem_bytes(int dtype, int d,
                                                    int kernel) {
  switch (bwd_route(dtype, d)) {
    case kRouteScalar:
      return (long long)(kernel ? bwd_dkdv_smem_bytes(d)
                                : bwd_dq_smem_bytes(d));
    case kRouteMmaSync:
      return (long long)tc_bwd_smem_bytes(d);
    case kRouteWgmma:
      return (long long)(kernel ? wg_dkdv_smem_bytes(d)
                                : wg_dq_smem_bytes(d));
    default:
      return 0;
  }
}

extern "C" int flash_attention_max_head_dim() { return kMaxD; }
