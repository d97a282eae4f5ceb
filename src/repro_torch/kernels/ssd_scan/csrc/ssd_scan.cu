// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunk scan with a carried
// [P, N] state, which it starts from `init_state` and writes back.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (`_kernel`, launched by `ssd_scan_kernel`).  That kernel runs a
// (B*H, chunks) grid whose chunk axis is sequential on one core, carrying
// the state in VMEM scratch between grid steps; it starts from zeros and
// drops the state at the end.  Blocks on Hopper run in no order, so here
// one block owns one (batch, head) and loops over the chunks itself, with
// the state in shared memory the whole time.  Per chunk of Q tokens, with
// cum = inclusive cumsum of dA = dt * A[h]:
//
//   scores[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j      (j <= i)
//   y_i          = sum_j scores[i][j] x_j + exp(cum_i) * (state C_i)
//   state        = exp(cum_last) * state + sum_j x_j (x) B_j * w_j,
//                  w_j = exp(cum_last - cum_j) * dt_j
//
// all in f32, the order of the TPU kernel.  The tensors stay in the model
// layout (x and y [B, S, H, P], dt [B, S, H], B and C [B, S, N]): the
// block reads its head's columns of x and the one group's B and C rows
// directly, where the TPU wrapper materialised B and C once per head
// (`jnp.repeat`).  A ragged last chunk is zero-filled on load (dt = 0
// there, so it neither decays nor feeds the state), as the reference's
// padding does.
//
// Shared memory: x [Q][P+1], B and C [Q][N+1], scores [Q][Q+1], state
// [P][N+1] and three Q-vectors, all f32: about 180 KB at Q = 128 and
// P = N = 64, so one block an SM, set as dynamic shared memory.
//
// Bound on this card: bytes.  At the serve shape (B = 4, S = 512,
// H = 112, P = N = 64, chunk 128, bf16, prefill into a cache, so with an
// f32 init_state) the scan must read x, dt, B, C and init_state and write
// y and the f32 final state: 74.8 MB, 22.3 us at 3.35 TB/s; the chunk
// GEMMs it needs (C B^T once per batch row and chunk, the
// lower-triangular scores times x, C times the state, the state update)
// are 5.7 GFLOP, 5.7 us at the bf16 tensor-core peak.  This first kernel
// computes with scalar f32 FMAs on shared-memory operands at one block (8
// warps) an SM, so it is bound by shared-memory bandwidth and latency and
// runs far above that bound; it reads each input from device memory once
// and writes each output once, and leaves the tensor cores (mma on the
// chunk GEMMs) and several heads per block sharing one C B^T to the PR
// that makes it fast.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernel
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) *
         ((size_t)Q * (P + 1) + 2 * (size_t)Q * (N + 1) +
          (size_t)Q * (Q + 1) + (size_t)P * (N + 1) + 3 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ final_state, int S,
               int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int lx = P + 1, ln = N + 1, lq = Q + 1;
  float* sx = smem;                  // [Q][lx]
  float* sb = sx + Q * lx;           // [Q][ln]
  float* sc = sb + Q * ln;           // [Q][ln]
  float* ss = sc + Q * ln;           // [Q][lq] scores
  float* st = ss + Q * lq;           // [P][ln] carried state
  float* sdt = st + P * ln;          // [Q]
  float* scum = sdt + Q;             // [Q]
  float* sw = scum + Q;              // [Q] exp(cum_last - cum_j) * dt_j

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const float a = A[h];

  const size_t x_row = (size_t)H * P;          // one token of x / y
  const T* xb = x + (size_t)b * S * x_row + (size_t)h * P;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* bb = Bm + (size_t)b * S * N;
  const T* cb = Cm + (size_t)b * S * N;
  const size_t state_off = (size_t)bh * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st[p * ln + n] = init ? init[state_off + i] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();                 // the previous chunk is consumed
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      const int t = t0 + j;
      sx[j * lx + p] = t < S ? to_f32(xb[(size_t)t * x_row + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      const int t = t0 + j;
      const bool in = t < S;
      sb[j * ln + n] = in ? to_f32(bb[(size_t)t * N + n]) : 0.f;
      sc[j * ln + n] = in ? to_f32(cb[(size_t)t * N + n]) : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads) {
      const int t = t0 + j;
      sdt[j] = t < S ? dtb[(size_t)t * H] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                  // inclusive cumsum of dA, in order
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += sdt[j] * a;
        scum[j] = run;
      }
    }
    __syncthreads();
    const float cum_last = scum[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      sw[j] = expf(cum_last - scum[j]) * sdt[j];

    // scores = (C B^T) * L * dt, lower triangle
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int r = i / Q, j = i - r * Q;
      float v = 0.f;
      if (j <= r) {
        const float* cr = sc + r * ln;
        const float* br = sb + j * ln;
        for (int n = 0; n < N; ++n) v = fmaf(cr[n], br[n], v);
        v = v * expf(scum[r] - scum[j]) * sdt[j];
      }
      ss[r * lq + j] = v;
    }
    __syncthreads();

    // y = scores x + exp(cum) * (C state^T), from the state before update
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const int t = t0 + r;
      if (t >= S) continue;
      const float* sr = ss + r * lq;
      float v = 0.f;
      for (int j = 0; j <= r; ++j) v = fmaf(sr[j], sx[j * lx + p], v);
      const float* cr = sc + r * ln;
      const float* sp = st + p * ln;
      float u = 0.f;
      for (int n = 0; n < N; ++n) u = fmaf(cr[n], sp[n], u);
      yb[(size_t)t * x_row + p] = from_f32<T>(v + u * expf(scum[r]));
    }
    __syncthreads();

    // state = exp(cum_last) * state + sum_j x_j (x) B_j * w_j
    const float decay = expf(cum_last);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float v = 0.f;
      for (int j = 0; j < Q; ++j)
        v = fmaf(sx[j * lx + p] * sw[j], sb[j * ln + n], v);
      st[p * ln + n] = st[p * ln + n] * decay + v;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    final_state[state_off + i] = st[p * ln + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* final_state,
           int B, int S, int H, int P, int N, int Q, void* stream) {
  const size_t smem = smem_bytes(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan<T><<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)init, (T*)y, (float*)final_state, S, H, P,
      N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, init_state and
// final_state are f32.  x/y [B, S, H, P], dt [B, S, H], A [H], B/C
// [B, S, N], init_state (or null for zeros) and final_state [B, H, P, N],
// all contiguous.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* final_state,
                               int dtype, int B, int S, int H, int P, int N,
                               int Q, void* stream) {
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, P,
                         N, Q, stream);
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B, S,
                               H, P, N, Q, stream);
}

extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  return (long long)smem_bytes(Q, P, N);
}
