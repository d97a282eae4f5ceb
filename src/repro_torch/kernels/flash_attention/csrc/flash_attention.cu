// flash_attention for Hopper (sm_90a): forward blocked online-softmax
// attention with GQA, causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (`_kernel`, launched by
// `flash_attention_kernel`).  That kernel walks a (BH, Sq/bq, Sk/bk) grid
// whose last axis runs in order on one core, carrying the running max,
// sum and accumulator in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in no order, so here one block owns one
// (batch*head, 64-row query tile) and runs the KV loop itself:
//
//   * 256 threads, four per query row; each thread holds its row's running
//     max and sum and a quarter of the row's f32 accumulator (columns
//     sub, sub + 4, ...) in registers for the whole KV loop;
//   * the Q tile and each 64-key K/V tile are staged in dynamic shared
//     memory in f32 (rows padded by one word against bank conflicts); the
//     row's 64 probabilities go through shared memory to the P.V product;
//   * GQA reads KV head h / (H / K) directly, with no repeated KV; the
//     tensors stay in the model layout [B, S, heads, d], so the wrapper
//     transposes nothing;
//   * causal and window masks use absolute positions from 0 for q and k;
//     whole KV tiles that no row of the tile can see are skipped; the
//     ragged edges (S not a multiple of 64) are masked here, where the TPU
//     kernel asserted S % block == 0;
//   * a masked score is -1e30 (NEG_INF, as in the TPU kernel) and its
//     probability is set to exactly 0, so a row with no visible key ends
//     with sum 0 and writes 0, as the plain version does.
//
// Bound on this card: bytes.  The kernel must read q, k and v once and
// write o once: at the serve shape (B = 4, S = 512, H = K = 32, d = 112,
// bf16) that is 58.7 MB, 17.5 us at 3.35 TB/s, while its causal work,
// 2 * B * H * S^2 * d = 7.5 GFLOP, takes 7.6 us at the bf16 tensor-core
// peak.  This first kernel is far from either: it does its products with
// scalar f32 FMAs on shared-memory operands (one shared load per FMA), so
// it is bound by shared-memory bandwidth and runs at some tens of times
// its bound.  It keeps the bytes at the minimum (each q, k, v element
// comes from device memory once per block that needs it, o is written
// once) and puts off the tensor cores (mma/wgmma on bf16 tiles fed by
// TMA) to the PR that makes it fast.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernel
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // four threads per query row
constexpr int kMaxD = 128;        // head dims up to this
constexpr int kCols = kMaxD / 4;  // accumulator columns per thread
constexpr int kKeys = kBK / 4;    // scores per thread per KV tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o: [B, Sq, H, d]; k/v: [B, Sk, K, d],
// all contiguous; H % K == 0; 1 <= d <= 128; scale = 1 / sqrt(d).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int K,
                                      int d, int causal, int window,
                                      float scale, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Sk, H, K, d, causal, window,
                         scale, stream);
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, K, d, causal,
                               window, scale, stream);
}

extern "C" int flash_attention_max_head_dim() { return kMaxD; }

extern "C" long long flash_attention_smem_bytes(int d) {
  return (long long)smem_bytes(d);
}
