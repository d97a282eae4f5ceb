// flash_attention for Hopper (sm_90a): forward blocked online-softmax
// attention with GQA, causal and sliding-window masks.
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
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
          int H, int K, int d, int causal, int window, float scale) {
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
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int d, int causal, int window,
           float scale, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, K, d, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;                 // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;

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
             const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
             int Sk, int H, int K, int d, int causal, int window,
             float scale_log2, int vec) {
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
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
              int Sq, int Sk, int H, int K, int d, int causal, int window,
              float scale, void* stream) {
  const size_t smem = tc_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc<DP><<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, o, Sq, Sk, H, K, d, causal, window, scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// q/o: [B, Sq, H, d]; k/v: [B, Sk, K, d], all contiguous; H % K == 0;
// 1 <= d <= 128; scale = 1 / sqrt(d).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int K,
                                      int d, int causal, int window,
                                      float scale, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Sk, H, K, d, causal, window,
                         scale, stream);
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  switch ((d + 15) / 16) {
#define FA_TC_CASE(n)                                                       \
  case n:                                                                   \
    return launch_tc<16 * n>(qb, kb, vb, ob, B, Sq, Sk, H, K, d, causal,    \
                             window, scale, stream);
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

extern "C" int flash_attention_max_head_dim() { return kMaxD; }
