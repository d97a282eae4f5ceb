// decode_attention for Hopper (sm_90a): one new query token a row against
// its layer's KV cache, read where it lies, at GQA size, over the filled
// positions only.
//
// Replaces no TPU kernel.  The JAX package's decode attention is jnp
// (src/repro/models/layers.py, `self_attention` with mode="decode", and
// `attention_scores`): it repeats the cache's K and V up to the query
// heads and attends over the whole cache, every position past the one
// being written masked out.  In eager PyTorch that is a copy of the
// [B, S_max, K, d] caches to [B, S_max, H, d] every layer and step, then
// two products over all S_max positions.  This kernel computes the same
// function from the cache as it is.
//
// Bound on this card: bytes.  The function must read q, the filled K and
// V rows of each KV head once, and write the output once:
// (2 B H d + 2 B n K d) * itemsize bytes for n filled positions a row,
// against 4 B H n d flops, one flop a byte in bf16.  qwen3-1.7b's served
// decode step (B = 61, H = 16, K = 8, d = 128, n = 525) reads 131 MB a
// layer, 39 us at 3.35 TB/s.
//
// Design (split-K decode, three passes, no atomics):
//
//   * `decode_attn_scores<T, G>`: one block of 128 threads per (row, KV
//     head, split of 128 keys).  The filled end hi = pos + 1 and the
//     window's start lo come from `positions`, a device tensor, so no
//     argument of the launch varies from step to step; the grid is sized
//     from S_max, and a block whose split lies wholly outside [lo, hi)
//     returns at once, reading and writing nothing.  The split's K rows go
//     from device memory to shared memory once, by 16-byte cp.async, rows
//     padded by 16 bytes so that reading them a row a thread is free of
//     bank conflicts; they serve all G = H / K query heads of the group
//     (query head h reads KV head h / G, `repeat_interleave`'s mapping).
//     Each thread takes one key: the G scores bf16(q . k) (f32 sums),
//     divided in f32 by sqrt(d) rounded to T and rounded to T again, as
//     the plain version rounds them.  The scores go to a scratch row
//     [B * H, S_max], and each head's (max, sum of exp(s - max)) over the
//     split to a scratch [B * H, n_split].
//   * `decode_attn_pv<T, G>`: the same grid.  Each block copies its V rows
//     likewise, meanwhile combines the row's per-split (max, sum) in a
//     fixed order into the row's max M and sum L, and makes the weights
//     round_T(exp(s - M) / L), the softmax of the whole filled row
//     rounded to T before the product with V, as the plain version rounds
//     them.  Thread (group of keys, 16-byte column chunk) sums w v over
//     its keys in f32 for all G heads; the groups' sums are added in
//     order through shared memory into a partial [B * H, n_split, d].
//   * `decode_attn_combine<T>`: one block per (head, row) adds the row's
//     partials split by split in order and rounds the sum to T.
//
// Every sum runs in an order fixed by the shapes and the positions alone:
// two launches on the same inputs give the same bits.  A row with no
// visible position (pos < lo) writes zeros.  T is bf16 or float (the
// examples' tiny models): float makes each rounding the identity.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernels
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // threads a block; a key a thread in pass 1
constexpr int kSplit = 128;     // keys a split
constexpr int kMaxGroup = 8;    // query heads a KV head
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of shared memory as 4 or 8 floats
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of its float
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// every lane ends with the same sum: each step adds a pair of lanes'
// values, and a + b == b + a
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// the positions row b attends: [lo, hi), hi = pos + 1 within the cache,
// lo the window's first where a window is set
__device__ __forceinline__ void row_range(const int* positions, int b, int S,
                                          int window, int& lo, int& hi) {
  const int pos = __ldg(positions + b);
  hi = min(max(pos + 1, 0), S);
  lo = window > 0 ? max(pos - window + 1, 0) : 0;
}

__host__ __device__ constexpr int vec_of(int itemsize) {
  return 16 / itemsize;
}

// shared memory of the two split passes: the split's K or V rows (padded
// by one 16-byte chunk), then pass 1's q in f32 and scores, pass 2's
// weights and the row's max and sum; pass 2 reuses the rows' space for
// its groups' sums
__host__ __device__ constexpr int tile_bytes(int itemsize, int d) {
  return kSplit * (d + vec_of(itemsize)) * itemsize;
}
__host__ __device__ constexpr int scores_smem_bytes(int itemsize, int G,
                                                    int d) {
  return tile_bytes(itemsize, d) + 4 * G * d + 4 * G * kSplit;
}
__host__ __device__ constexpr int pv_smem_bytes(int itemsize, int G, int d) {
  const int split = tile_bytes(itemsize, d) + 4 * G * kSplit + 8 * G;
  const int sums = 4 * (kThreads / (d / vec_of(itemsize))) * G * d;
  return split > sums ? split : sums;
}
static_assert(kThreads == kSplit, "pass 1 takes a key a thread");

// The split's rows [k0, k1) of one KV head, at their place in the tile.
template <typename T>
__device__ __forceinline__ void copy_rows(T* tile, const T* src, int base,
                                          int k0, int k1, int d,
                                          long long ss) {
  constexpr int V = vec_of(sizeof(T));
  const int ch = d / V, pitch = d + V;
  for (int i = threadIdx.x; i < (k1 - k0) * ch; i += kThreads) {
    const int r = k0 - base + i / ch, c = i % ch;
    tc::cp_async16(tile + r * pitch + c * V,
                   src + (long long)(base + r) * ss + c * V, 16);
  }
  tc::cp_async_commit();
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attn_scores(const T* __restrict__ q, const T* __restrict__ k,
                       const int* __restrict__ positions,
                       float* __restrict__ scores,
                       float2* __restrict__ stats, int S, int H, int d,
                       long long sb, long long ss, long long sh, int window,
                       float root, int n_split) {
  constexpr int V = vec_of(sizeof(T));
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  row_range(positions, b, S, window, lo, hi);
  const int base = j * kSplit;
  const int k0 = max(base, lo), k1 = min(base + kSplit, hi);
  if (k0 >= k1) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = d / V, pitch = d + V;
  T* tile = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + tile_bytes(sizeof(T), d));
  float* sc = qs + G * d;
  copy_rows(tile, k + b * sb + kh * sh, base, k0, k1, d, ss);
  const long long h0 = (long long)b * H + kh * G;   // the group's first head
  for (int i = threadIdx.x; i < G * d; i += kThreads)
    qs[i] = to_f(q[h0 * d + i]);
  tc::cp_async_wait<0>();
  __syncthreads();

  const int t = threadIdx.x, key = base + t;
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.f;
  if (key >= k0 && key < k1) {
    const T* row = tile + t * pitch;
    for (int c = 0; c < ch; ++c) {
      float kv[V];
      load16(row + c * V, kv);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < V; ++e)
          s[g] = fmaf(qs[g * d + c * V + e], kv[e], s[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = round_t<T>(round_t<T>(s[g]) / root);
      scores[(h0 + g) * S + key] = s[g];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = -CUDART_INF_F;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) sc[g * kSplit + t] = s[g];
  __syncthreads();

  // each head's (max, sum) over the split: a warp a head
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < G; g += kThreads / 32) {
    float m = -CUDART_INF_F;
    for (int i = lane; i < kSplit; i += 32) m = fmaxf(m, sc[g * kSplit + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < kSplit; i += 32) l += expf(sc[g * kSplit + i] - m);
    l = warp_sum(l);
    if (lane == 0) stats[(h0 + g) * n_split + j] = make_float2(m, l);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attn_pv(const T* __restrict__ v, const int* __restrict__ positions,
                   const float* __restrict__ scores,
                   const float2* __restrict__ stats,
                   float* __restrict__ partial, int S, int H, int d,
                   long long sb, long long ss, long long sh, int window,
                   int n_split) {
  constexpr int V = vec_of(sizeof(T));
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  row_range(positions, b, S, window, lo, hi);
  const int base = j * kSplit;
  const int k0 = max(base, lo), k1 = min(base + kSplit, hi);
  if (k0 >= k1) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = d / V, pitch = d + V;
  T* tile = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(smem + tile_bytes(sizeof(T), d));
  float* gm = ws + G * kSplit;
  float* gl = gm + G;
  copy_rows(tile, v + b * sb + kh * sh, base, k0, k1, d, ss);
  const long long h0 = (long long)b * H + kh * G;

  // the row's max and sum of each head, from its splits in order
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int jlo = lo / kSplit, jhi = (hi - 1) / kSplit;
  for (int g = warp; g < G; g += kThreads / 32) {
    const float2* st = stats + (h0 + g) * n_split;
    float m = -CUDART_INF_F;
    for (int i = jlo + lane; i <= jhi; i += 32) m = fmaxf(m, st[i].x);
    m = warp_max(m);
    float l = 0.f;
    for (int i = jlo + lane; i <= jhi; i += 32) {
      const float2 x = st[i];
      l += x.y * expf(x.x - m);
    }
    l = warp_sum(l);
    if (lane == 0) gm[g] = m, gl[g] = l;
  }
  __syncthreads();
  for (int i = t; i < G * kSplit; i += kThreads) {
    const int g = i / kSplit, key = base + i % kSplit;
    ws[i] = key >= k0 && key < k1
                ? round_t<T>(expf(scores[(h0 + g) * S + key] - gm[g]) / gl[g])
                : 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // thread (kg, c): column chunk c over keys k0 + kg, k0 + kg + nkg, ...
  const int nkg = kThreads / ch, kg = t / ch, c = t % ch;
  float acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  if (kg < nkg) {
    for (int r = k0 - base + kg; r < k1 - base; r += nkg) {
      float vv[V];
      load16(tile + r * pitch + c * V, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = ws[g * kSplit + r];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(w, vv[e], acc[g][e]);
      }
    }
  }
  __syncthreads();   // the rows are read: their space takes the groups' sums
  float* red = reinterpret_cast<float*>(smem);
  if (kg < nkg) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(kg * G + g) * d + c * V + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = t; i < G * d; i += kThreads) {
    float sum = 0.f;
    for (int p = 0; p < nkg; ++p) sum += red[p * G * d + i];
    partial[((h0 + i / d) * n_split + j) * d + i % d] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine(const float* __restrict__ partial,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int S, int H, int d, int window, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  row_range(positions, b, S, window, lo, hi);
  const long long row = (long long)b * H + h;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = 0.f;
    if (lo < hi)
      for (int j = lo / kSplit; j <= (hi - 1) / kSplit; ++j)
        sum += partial[(row * n_split + j) * d + c];
    out[row * d + c] = from_f<T>(sum);
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const int* positions,
           void* out, float* scores, float2* stats, float* partial, int B,
           int S, int H, int K, int d, long long sb, long long ss,
           long long sh, int window, float root, cudaStream_t stream) {
  const int n_split = (S + kSplit - 1) / kSplit;
  const dim3 grid(n_split, K, B);
  const int s1 = scores_smem_bytes(sizeof(T), G, d);
  const int s2 = pv_smem_bytes(sizeof(T), G, d);
  cudaError_t err;
  if (s1 > 48 * 1024 &&
      (err = cudaFuncSetAttribute(decode_attn_scores<T, G>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess)
    return (int)err;
  if (s2 > 48 * 1024 &&
      (err = cudaFuncSetAttribute(decode_attn_pv<T, G>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return (int)err;
  decode_attn_scores<T, G><<<grid, kThreads, s1, stream>>>(
      (const T*)q, (const T*)k, positions, scores, stats, S, H, d, sb, ss, sh,
      window, root, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decode_attn_pv<T, G><<<grid, kThreads, s2, stream>>>(
      (const T*)v, positions, scores, stats, partial, S, H, d, sb, ss, sh,
      window, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decode_attn_combine<T><<<dim3(H, B), kThreads, 0, stream>>>(
      partial, positions, (T*)out, S, H, d, window, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group(int G, const void* q, const void* k, const void* v,
                 const int* positions, void* out, float* scores,
                 float2* stats, float* partial, int B, int S, int H, int K,
                 int d, long long sb, long long ss, long long sh, int window,
                 float root, cudaStream_t stream) {
  switch (G) {
#define DA_CASE(n)                                                        \
  case n:                                                                 \
    return launch<T, n>(q, k, v, positions, out, scores, stats, partial, \
                        B, S, H, K, d, sb, ss, sh, window, root, stream);
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(3)
    DA_CASE(4)
    DA_CASE(5)
    DA_CASE(6)
    DA_CASE(7)
    DA_CASE(8)
#undef DA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, H, d] contiguous; k and v: [B, S, K, d] views with the element
// strides (sb, ss, sh, 1), rows on 16 bytes; positions int32 [B]; out
// [B, 1, H, d]; scores f32 [B * H, S], stats f32 [B * H, n_split, 2] and
// partial f32 [B * H, n_split, d] scratch, n_split = ceil(S / 128), each
// on 16 bytes.  dtype 0 is float, 1 bf16; root is sqrt(d) rounded to it.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* positions,
    void* out, float* scores, float* stats, float* partial, int dtype, int B,
    int S, int H, int K, int d, long long sb, long long ss, long long sh,
    int window, float root, void* stream) {
  const int itemsize = dtype == 1 ? 2 : 4;
  const int V = vec_of(itemsize);
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || K < 1 || H % K ||
      H / K > kMaxGroup || d < 1 || d > kMaxD || d % V || sb % V || ss % V ||
      sh % V || B > 65535 || H > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float2* stats2 = reinterpret_cast<float2*>(stats);
  if (dtype == 1)
    return launch_group<bf16>(H / K, q, k, v, positions, out, scores, stats2,
                              partial, B, S, H, K, d, sb, ss, sh, window,
                              root, st);
  return launch_group<float>(H / K, q, k, v, positions, out, scores, stats2,
                             partial, B, S, H, K, d, sb, ss, sh, window, root,
                             st);
}

// keys a split (the scratch's n_split is ceil(S / this))
extern "C" int decode_attention_split() { return kSplit; }
