// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunk scan with a carried
// [P, N] state, which it starts from `init_state` and writes back.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (`_kernel`, launched by `ssd_scan_kernel`).  That kernel runs a
// (B*H, chunks) grid whose chunk axis is sequential on one core, carrying
// the state in VMEM scratch between grid steps; it starts from zeros and
// drops the state at the end.  Blocks on Hopper run in no order, so here
// one block owns one (batch, head) -- or one 64-wide slice of a head's P
// columns, which are independent -- and loops over the chunks itself.
// Per chunk of Q tokens, with cum = inclusive cumsum of dA = dt * A[h]:
//
//   G            = C B^T                                     [Q x Q]
//   scores[i][j] = G[i][j] * exp(cum_i - cum_j) * dt_j        (j <= i)
//   y_i          = sum_j scores[i][j] x_j + exp(cum_i) * (C_i S^T)
//   S            = exp(cum_last) * S + x^T (B o w),
//                  w_j = exp(cum_last - cum_j) * dt_j
//
// The tensors stay in the model layout (x and y [B, S, H, P], dt
// [B, S, H], B and C [B, S, N]).  x, B and C are read through their batch
// and token strides, so the model's slices of its fused xBC activation go
// in as they are; the block reads its head's columns of x and the one
// group's B and C rows directly, where the TPU wrapper materialised B and
// C once per head (`jnp.repeat`).  A ragged last chunk is zero-filled on
// load (dt = 0 there, so it neither decays nor feeds the state), as the
// reference's padding does.  The dtype and shape pick one of three routes
// (`fwd_route`; kernel.py's `fwd_route` holds the same rule and checks it
// against this library):
//
// bf16 at P <= 64, N <= 128, chunks of up to 128 (every SSM arch) -- three
// chunk-parallel passes on wgmma (see "forward: bf16 on wgmma, three
// chunk-parallel passes" below);
//
// any other bf16 shape -- `ssd_scan_tc`, the four chunk products on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators), 4
// warps a block:
//
//   * the chunk's x and B (bf16) and dt (f32) are double-buffered in
//     shared memory and loaded with cp.async, the next chunk's while this
//     one computes; C, which only the y products read, has one buffer and
//     is reloaded while the state update runs.  Q, P and N are padded to
//     multiples of 16 with zeros, and a 64- or 128-element row is
//     XOR-swizzled (else padded by 8) so ldmatrix is conflict-free.  At
//     Q = 128, P = N = 64 that is 97.5 KB, so two blocks fit an SM;
//   * cum is a parallel scan: __shfl_up_sync in each warp, then across
//     the four warps through shared memory;
//   * y: each warp owns 16-row blocks of the chunk (snake order, so the
//     triangle's work is even across warps).  C's A fragments are loaded
//     once per row block and serve both C S^T and G = C B^T.  The
//     accumulator starts as C S^T scaled by exp(cum_i); then for each
//     16-column block j <= i: G's tile on the tensor cores, the decay and
//     dt (and the j <= i mask on the diagonal block) applied to the f32
//     accumulator, turned in registers into A fragments, and multiplied
//     by x's tile (ldmatrix.trans) into y.  Blocks above the diagonal are
//     never computed;
//   * the state: warp w owns rows [16 w, 16 w + 16) of S in f32 registers
//     for the whole chunk loop (never rounded from one chunk to the next).
//     S <- exp(cum_last) S + x^T (B o w): x^T's A fragments by
//     ldmatrix.trans, B's by ldmatrix.trans scaled by w_j in registers.
//     After each update the warp writes its rows to shared memory as the
//     B operand of the next chunk's C S^T;
//   * roundings: the three f32 operands that feed an mma -- scores, B o w
//     and the state in C S^T -- each go in as a bf16 high part plus a
//     bf16 low part (two mma), about 16 bits of mantissa.  With one bf16
//     each the first card run failed the 5e-2 check at the serve shape
//     (0.283 on y where the intra- and inter-chunk terms cancel);
//     tests/test_torch_tensor_core_rounding.py models the split.  The
//     only other roundings are the bf16 inputs and output.
//
// f32 -- `ssd_chunk_scan<float>`, the scalar kernel of the first port,
// kept for the f32 checks (1e-4): one block of 256 threads per (batch,
// head), everything in f32 shared memory (about 180 KB at Q = 128,
// P = N = 64), scalar FMAs.  Where a head's P columns do not fit a
// block's 232,448 bytes (mamba2-370m: Q = 128, P = 64, N = 128 needs
// 265,984), the columns are split over blocks as the bf16 kernel splits
// them: `f32_slice` halves the slice until it fits (16 there, 216,640
// bytes), and each block recomputes the chunk's scores for its slice.
// An unsplit head runs as before.
//
// Bound on this card: bytes.  At the serve shape (B = 4, S = 512,
// H = 112, P = N = 64, chunk 128, bf16, prefill into a cache, so with an
// f32 init_state) the scan must read x, dt, B, C and init_state and write
// y and the f32 final state: 74.8 MB, 22.3 us at 3.35 TB/s; the chunk
// GEMMs it needs (C B^T once per batch row and chunk, the
// lower-triangular scores times x, C times the state, the state update)
// are 5.7 GFLOP, 5.7 us at the bf16 tensor-core peak.  What keeps the
// bf16 kernel off that bound: each block recomputes C B^T for its own
// head (112 times the needed work of that product), the split operands
// double three of the four products, the chunks of a head run one after
// another with four barriers each, mma.sync reaches only part of the
// wgmma rate, and 448 blocks make 1.7 waves of 264 slots.  chip_smoke.py
// measured it at about 0.17 ms on an H100 SXM at 700 W, some 8x the
// bound (and 0.95 ms, 22.5x, at mamba2-370m's training shape, where its
// 64 blocks each walk 32 chunks); tools/kernel_variants.py times each
// part of the work (C B^T is under a tenth of it).  The wgmma passes
// below take those shapes now.
//
// The backward (`ssd_scan_bwd_launch`) has no TPU kernel to replace: the
// reference trains by differentiating its jnp ssd_chunked
// (src/repro/models/mamba2.py).  It computes that gradient -- dx, ddt,
// dA, dB, dC and d init_state from dy and d final -- from the state each
// chunk starts from, which the forward writes under autograd (`states`).
// The gradient of the state chunk c ends with obeys the reverse recurrence
//
//   dS_c = exp(cum_last,c+1) dS_c+1 + Delta_c+1,
//   Delta_c = (dy_c o exp(cum_c))^T C_c,
//
// from dS_last = d final; what it leaves past the first chunk is d
// init_state.  f32 runs the scalar kernels: a carry pass (one block
// per (batch, head, slice of P) walking the chunks from last to first), a
// chunk pass (one block per (batch, chunk, head): dx, the head's parts of
// dB and dC, ddt and its part of dA through d cum) and a reduction of the
// heads' parts in a fixed order.  bf16 splits the recurrence as Mamba2's
// forward splits its own (chunk states, then state passing), run
// backwards: a delta pass computes every chunk's Delta at once on wgmma,
// a scan over the chunks, parallel over (batch, head, element of the
// state), turns them into dS, and the chunk pass -- on wgmma, a block
// owning a (batch, chunk) and a group of heads -- computes C B^T once for
// the group, dy x^T once a head, and sums dB and dC over the group's
// heads in the block before the reduction over groups (see "backward:
// bf16 on wgmma" below).
//
// Nothing is summed with atomics, so two calls give the same bits (a
// resumed training run must repeat its steps).  Bound on this card:
// bytes.  At mamba2-370m's training microbatch (B = 2, S = 4096, H = 32,
// P = 64, N = 128) the function must read x, dy, B, C, dt and the f32
// chunk states and write dx, ddt, dB and dC: 178 MB, 53 us at 3.35 TB/s,
// against 30.3 GFLOP of chunk products (31 us at the bf16 peak).  What
// keeps the bf16 passes off that bound: the Deltas and the state
// gradients go through device memory (the scan reads the Deltas and the
// states, 134 MB, and writes their split, 134 MB, at that shape), the
// chunk pass reads x and dS twice (for dB after the head loop: its
// registers hold dC's sum and dGsum), every product is an m64n64 wgmma
// waited on at once, and the elementwise work on the triangle (exp2, G,
// the masks) is done per element in both orientations; the SSD
// backward's times are in chip_smoke.py's kernels line and PERF.md.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernels
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tma_wgmma.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block

// Offset of chunk c's [P, N] state of (b, h) in a [B, C, H, P, N] tensor
// (the chunk start states the forward writes for the backward, and the
// state gradients the backward's carry pass writes).
__host__ __device__ inline size_t chunk_state_off(int b, int c, int h,
                                                  int n_chunks, int H, int P,
                                                  int N) {
  return (((size_t)b * n_chunks + c) * H + h) * (size_t)P * N;
}

// The f32 kernel's dynamic shared memory for a block of P columns.
size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) *
         ((size_t)Q * (P + 1) + 2 * (size_t)Q * (N + 1) +
          (size_t)Q * (Q + 1) + (size_t)P * (N + 1) + 3 * (size_t)Q);
}

// Columns of P a block of the f32 kernel owns: P, else P halved (rounded
// up) until the block fits kSmemLimit; 0 when not even one column fits.
int f32_slice(int Q, int P, int N) {
  int w = P;
  while (w > 1 && smem_bytes(Q, w, N) > kSmemLimit) w = (w + 1) / 2;
  return smem_bytes(Q, w, N) <= kSmemLimit ? w : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ final_state,
               float* __restrict__ states, int S,
               int H, int P, int N, int Q, int PS, long long xsb,
               long long xst, long long bsb, long long bst, long long csb,
               long long cst) {
  extern __shared__ float smem[];
  // this block's columns: [p0, p0 + pw) of the head's P, in slices of PS
  const int n_slices = (P + PS - 1) / PS;
  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * PS;
  const int pw = min(PS, P - p0);
  const int lx = pw + 1, ln = N + 1, lq = Q + 1;
  float* sx = smem;                  // [Q][lx]
  float* sb = sx + Q * lx;           // [Q][ln]
  float* sc = sb + Q * ln;           // [Q][ln]
  float* ss = sc + Q * ln;           // [Q][lq] scores
  float* st = ss + Q * lq;           // [pw][ln] carried state
  float* sdt = st + pw * ln;         // [Q]
  float* scum = sdt + Q;             // [Q]
  float* sw = scum + Q;              // [Q] exp(cum_last - cum_j) * dt_j

  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const float a = A[h];

  const size_t x_row = (size_t)H * P;          // one token of y
  const T* xb = x + b * xsb + (size_t)h * P + p0;
  T* yb = y + (size_t)b * S * x_row + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;
  const size_t state_off = ((size_t)bh * P + p0) * N;

  for (int i = tid; i < pw * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st[p * ln + n] = init ? init[state_off + i] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();                 // the previous chunk is consumed
    if (states) {                    // the state this chunk starts from
      float* sp = states + chunk_state_off(b, c, h, n_chunks, H, P, N) +
                  (size_t)p0 * N;
      for (int i = tid; i < pw * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        sp[i] = st[p * ln + n];
      }
    }
    for (int i = tid; i < Q * pw; i += kThreads) {
      const int j = i / pw, p = i - j * pw;
      const int t = t0 + j;
      sx[j * lx + p] = t < S ? to_f32(xb[t * xst + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      const int t = t0 + j;
      const bool in = t < S;
      sb[j * ln + n] = in ? to_f32(bb[t * bst + n]) : 0.f;
      sc[j * ln + n] = in ? to_f32(cb[t * cst + n]) : 0.f;
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
    for (int i = tid; i < Q * pw; i += kThreads) {
      const int r = i / pw, p = i - r * pw;
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
    for (int i = tid; i < pw * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float v = 0.f;
      for (int j = 0; j < Q; ++j)
        v = fmaf(sx[j * lx + p] * sw[j], sb[j * ln + n], v);
      st[p * ln + n] = st[p * ln + n] * decay + v;
    }
  }
  __syncthreads();
  for (int i = tid; i < pw * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    final_state[state_off + i] = st[p * ln + n];
  }
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* init, void* y, void* final_state,
               void* states, int B, int S, int H, int P, int N, int Q,
               long long xsb, long long xst, long long bsb, long long bst,
               long long csb, long long cst, void* stream) {
  const int PS = f32_slice(Q, P, N);
  if (PS == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, PS, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * H * ((P + PS - 1) / PS);
  ssd_chunk_scan<float><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)init, (float*)y, (float*)final_state,
      (float*)states, S, H, P, N, Q, PS, xsb, xst, bsb, bst, csb, cst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kSliceP = 64;          // P columns a block owns

// Shared-memory layout of the bf16 kernel: two stages of [x | B | dt] for
// one chunk, one C tile (C is read first and reloaded while the state
// update runs), the state's bf16 high and low parts, cum, and the four
// warps' scan totals.
struct TcLayout {
  int Qp, Np, XW;                    // chunk, N and slice width, padded
  int xp, xs, np, ns;                // pitch and swizzle of x and B/C
  size_t stage, total;               // bytes
};

__host__ __device__ inline TcLayout tc_layout(int Q, int P, int N) {
  TcLayout L;
  L.Qp = (Q + 15) / 16 * 16;
  L.Np = (N + 15) / 16 * 16;
  const int pp = (P + 15) / 16 * 16;
  L.XW = pp < kSliceP ? pp : kSliceP;
  L.xp = tc::tile_pitch(L.XW);
  L.xs = tc::tile_swz(L.XW);
  L.np = tc::tile_pitch(L.Np);
  L.ns = tc::tile_swz(L.Np);
  L.stage = sizeof(bf16) * (size_t)L.Qp * (L.xp + L.np) +
            sizeof(float) * (size_t)L.Qp;
  L.total = 2 * L.stage + sizeof(bf16) * (size_t)L.Qp * L.np +
            sizeof(bf16) * 2 * (size_t)L.XW * L.np +
            sizeof(float) * ((size_t)L.Qp + kTcWarps);
  return L;
}

// Pointers into the layout; stage s of x, B and dt is stage 0's plus
// s * L.stage bytes (no array indexed at run time, so nothing spills to
// the stack).
struct Smem {
  unsigned char* base;
  size_t stage;
  bf16 *c, *s_hi, *s_lo;
  float *cum, *warp_sum;
  int b_off, dt_off;                 // bytes into a stage
  __device__ bf16* x(int s) const {
    return reinterpret_cast<bf16*>(base + s * stage);
  }
  __device__ bf16* b(int s) const {
    return reinterpret_cast<bf16*>(base + s * stage + b_off);
  }
  __device__ float* dt(int s) const {
    return reinterpret_cast<float*>(base + s * stage + dt_off);
  }
};

__device__ __forceinline__ Smem carve(unsigned char* smem,
                                      const TcLayout& L) {
  Smem m;
  m.base = smem;
  m.stage = L.stage;
  m.b_off = (int)sizeof(bf16) * L.Qp * L.xp;
  m.dt_off = m.b_off + (int)sizeof(bf16) * L.Qp * L.np;
  m.c = reinterpret_cast<bf16*>(smem + 2 * L.stage);
  m.s_hi = m.c + L.Qp * L.np;
  m.s_lo = m.s_hi + L.XW * L.np;
  m.cum = reinterpret_cast<float*>(m.s_lo + L.XW * L.np);
  m.warp_sum = m.cum + L.Qp;
  return m;
}

template <int NT = kTcThreads>      // threads of the block
__device__ __forceinline__ void zero_cols(bf16* t, int rows, int c0, int c1,
                                          int pitch, int swz) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < rows * w; i += NT) {
    const int r = i / w;
    t[tc::tile_off(r, c0 + i - r * w, pitch, swz)] = __float2bfloat16(0.f);
  }
}

// Columns [0, width) of tokens t0 .. t0 + Qp - 1 into a [Qp][pitch] bf16
// tile; rows from `rows` on (past the chunk or the sequence) are zero.
// vec: 16-byte cp.async (every row start 16-byte aligned, width % 8 ==
// 0), else plain loads.
template <int NT = kTcThreads>
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, int swz,
                                          const bf16* src, long long stride,
                                          int t0, int rows, int Qp,
                                          int width, bool vec) {
  if (vec) {
    const int chunks = width >> 3;
    for (int i = threadIdx.x; i < Qp * chunks; i += NT) {
      const int j = i / chunks, c = (i - j * chunks) << 3;
      const bool in = j < rows;
      tc::cp_async16(dst + tc::tile_off(j, c, pitch, swz),
                     in ? src + (t0 + j) * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * width; i += NT) {
      const int j = i / width, c = i - j * width;
      dst[tc::tile_off(j, c, pitch, swz)] =
          j < rows ? src[(t0 + j) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// dt of tokens t0 .. t0 + Qp - 1 (stride H), zero from `rows` on.
template <int NT = kTcThreads>
__device__ __forceinline__ void load_dt(float* dst, const float* src, int H,
                                        int t0, int rows, int Qp,
                                        bool vec) {
  for (int j = threadIdx.x; j < Qp; j += NT) {
    const bool in = j < rows;
    if (vec)
      tc::cp_async4(dst + j, in ? src + (size_t)(t0 + j) * H : src,
                    in ? 4 : 0);
    else
      dst[j] = in ? src[(size_t)(t0 + j) * H] : 0.f;
  }
}

// cum[j] = inclusive cumsum of sdt[j] * a over j < Qp: a shuffle scan in
// each warp, then across the NW warps of the block through `warp_sum`.
// Every thread of the block calls it; it ends with a barrier.
template <int NW>
__device__ __forceinline__ void chunk_cumsum(const float* sdt, float a,
                                             float* cum, float* warp_sum,
                                             int Qp) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float carry = 0.f;
  for (int base = 0; base < Qp; base += 32 * NW) {
    const int j = base + tid;
    float v = j < Qp ? sdt[j] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre += warp_sum[w];
    if (j < Qp) cum[j] = v + pre;
#pragma unroll
    for (int w = 0; w < NW; ++w) carry += warp_sum[w];
    __syncthreads();
  }
}

// Rows pr and pr + 8 of the f32 state, as the accumulator fragment holds
// them, into the high and low bf16 parts that are the B operand of C S^T.
template <int NTN>
__device__ __forceinline__ void publish_state(const float (&st)[NTN][4],
                                              const Smem& m,
                                              const TcLayout& L, int pr,
                                              int lane) {
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    if (nt * 8 >= L.Np) continue;
    const int c = nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = tc::tile_off(pr + 8 * half, c, L.np, L.ns);
      tc::split_bf16(st[nt][2 * half], st[nt][2 * half + 1],
                     *reinterpret_cast<uint32_t*>(m.s_hi + o),
                     *reinterpret_cast<uint32_t*>(m.s_lo + o));
    }
  }
}

template <int NTN>   // n8-tiles of N allocated: 8 (N <= 64) or 16 (<= 128)
__global__ void __launch_bounds__(kTcThreads, 2)   // shared memory: 2 an SM
ssd_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, const float* __restrict__ init,
            bf16* __restrict__ y, float* __restrict__ final_state,
            float* __restrict__ states, int S,
            int H, int P, int N, int Q, long long xsb, long long xst,
            long long bsb, long long bst, long long csb, long long cst,
            int vec) {
  constexpr int KS = NTN / 2;        // k-steps over N allocated
  extern __shared__ __align__(128) unsigned char ssd_smem[];
  const TcLayout L = tc_layout(Q, P, N);
  const Smem m = carve(ssd_smem, L);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_slices = (P + kSliceP - 1) / kSliceP;
  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * kSliceP;
  const int pw = min(kSliceP, P - p0);
  const int b = bh / H;
  const int h = bh - b * H;
  const float a = A[h];
  const int nks = L.Np / 16;         // k-steps over N
  const int npp = L.XW / 16;         // pairs of p n8-tiles
  const int nrb = L.Qp / 16;         // 16-row blocks of a chunk

  const bf16* xb = x + b * xsb + (size_t)h * P + p0;
  const bf16* bb = Bm + b * bsb;
  const bf16* cb = Cm + b * csb;
  const float* dtb = dt + (size_t)b * S * H + h;

  // padding columns no load writes: x past the slice, B and C past N
  for (int s = 0; s < 2; ++s) {
    zero_cols(m.x(s), L.Qp, pw, L.XW, L.xp, L.xs);
    zero_cols(m.b(s), L.Qp, N, L.Np, L.np, L.ns);
  }
  zero_cols(m.c, L.Qp, N, L.Np, L.np, L.ns);

  const int n_chunks = (S + Q - 1) / Q;
  {
    const int rows = min(Q, S);
    load_rows(m.x(0), L.xp, L.xs, xb, xst, 0, rows, L.Qp, pw, vec);
    load_rows(m.b(0), L.np, L.ns, bb, bst, 0, rows, L.Qp, N, vec);
    load_rows(m.c, L.np, L.ns, cb, cst, 0, rows, L.Qp, N, vec);
    load_dt(m.dt(0), dtb, H, 0, rows, L.Qp, vec);
    tc::cp_async_commit();
  }

  // warp w holds rows pr, pr + 8 of S (slice-local) in f32 registers
  const bool owns = warp * 16 < L.XW;
  const int pr = warp * 16 + (lane >> 2);
  const size_t state_off = (size_t)bh * P * N + (size_t)p0 * N;
  float st[NTN][4];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pr + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
      st[nt][e] = init && owns && p < pw && n < N
                      ? init[state_off + (size_t)p * N + n] : 0.f;
    }
  }
  if (owns) publish_state(st, m, L, pr, lane);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const int rows = min(Q, S - t0);           // valid rows of the chunk
    const int next_rows = min(Q, S - t0 - Q);  // of the next, if any
    const int cs = ch & 1;
    tc::cp_async_wait<0>();
    __syncthreads();                 // this chunk and the state parts landed
    if (ch + 1 < n_chunks) {         // the next x, B and dt load meanwhile
      load_rows(m.x(cs ^ 1), L.xp, L.xs, xb, xst, t0 + Q, next_rows, L.Qp,
                pw, vec);
      load_rows(m.b(cs ^ 1), L.np, L.ns, bb, bst, t0 + Q, next_rows, L.Qp,
                N, vec);
      load_dt(m.dt(cs ^ 1), dtb, H, t0 + Q, next_rows, L.Qp, vec);
      tc::cp_async_commit();
    }
    const bf16* sx = m.x(cs);
    const bf16* sb = m.b(cs);
    const float* sdt = m.dt(cs);
    if (states && owns) {            // the state this chunk starts from
      float* sp = states + chunk_state_off(b, ch, h, n_chunks, H, P, N) +
                  (size_t)p0 * N;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = pr + (e >> 1) * 8,
                    n = nt * 8 + (lane & 3) * 2 + (e & 1);
          if (p < pw && n < N) sp[(size_t)p * N + n] = st[nt][e];
        }
      }
    }

    // cum = inclusive cumsum of dt * a
    chunk_cumsum<kTcWarps>(sdt, a, m.cum, m.warp_sum, L.Qp);
    const float* scum = m.cum;
    const float cum_last = scum[L.Qp - 1];   // padded rows add dt = 0

    // y, one 16-row block at a time, in snake order over the warps
    for (int g = 0; g * kTcWarps < nrb; ++g) {
      const int rb = g * kTcWarps + ((g & 1) ? kTcWarps - 1 - warp : warp);
      const int i0 = rb * 16;
      if (rb >= nrb || i0 >= rows) continue;
      uint32_t cf[KS][4];            // C's A fragments, rows i0..i0+15
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks < nks)
          tc::ldsm_x4(cf[ks], m.c + tc::tile_off(i0 + (lane & 15),
                                                 ks * 16 + (lane >> 4) * 8,
                                                 L.np, L.ns));
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // inter-chunk: exp(cum_i) * (C S^T), the state before this chunk,
      // as its high part plus its low part
#pragma unroll
      for (int pp = 0; pp < kSliceP / 16; ++pp) {
        if (pp >= npp) continue;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nks) continue;
          const int o = tc::tile_off(pp * 16 + (lane & 7) + (lane >> 4) * 8,
                                     ks * 16 + ((lane >> 3) & 1) * 8, L.np,
                                     L.ns);
          uint32_t hi[4], lo[4];
          tc::ldsm_x4(hi, m.s_hi + o);
          tc::ldsm_x4(lo, m.s_lo + o);
          tc::mma(acc[2 * pp], cf[ks], hi[0], hi[1]);
          tc::mma(acc[2 * pp + 1], cf[ks], hi[2], hi[3]);
          tc::mma(acc[2 * pp], cf[ks], lo[0], lo[1]);
          tc::mma(acc[2 * pp + 1], cf[ks], lo[2], lo[3]);
        }
      }
      const int ia = i0 + (lane >> 2), ib = ia + 8;
      const float ca = scum[ia], cb2 = scum[ib];
      const float ea = expf(ca), eb = expf(cb2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
      // intra-chunk: 16 columns j of scores at a time, j <= i only (two
      // at a time in flight, so one G tile's mma latency hides behind the
      // other's score math)
#pragma unroll 2
      for (int jk = 0; jk <= rb; ++jk) {
        float gs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nks) continue;
          uint32_t bk[4];
          tc::ldsm_x4(bk, sb + tc::tile_off(
                                   jk * 16 + (lane & 7) + (lane >> 4) * 8,
                                   ks * 16 + ((lane >> 3) & 1) * 8, L.np,
                                   L.ns));
          tc::mma(gs[0], cf[ks], bk[0], bk[1]);
          tc::mma(gs[1], cf[ks], bk[2], bk[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = jk * 16 + nt * 8 + (lane & 3) * 2 + (e & 1);
            const int i = e < 2 ? ia : ib;
            const float v = gs[nt][e] * __expf((e < 2 ? ca : cb2) - scum[j]) *
                            sdt[j];
            gs[nt][e] = j <= i ? v : 0.f;
          }
        }
        // scores as A fragments, high part and low part
        uint32_t sh[4], sl[4];
        tc::split_bf16(gs[0][0], gs[0][1], sh[0], sl[0]);
        tc::split_bf16(gs[0][2], gs[0][3], sh[1], sl[1]);
        tc::split_bf16(gs[1][0], gs[1][1], sh[2], sl[2]);
        tc::split_bf16(gs[1][2], gs[1][3], sh[3], sl[3]);
#pragma unroll
        for (int pp = 0; pp < kSliceP / 16; ++pp) {
          if (pp >= npp) continue;
          uint32_t bx[4];
          tc::ldsm_x4_t(bx, sx + tc::tile_off(
                                    jk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    pp * 16 + (lane >> 4) * 8, L.xp, L.xs));
          tc::mma(acc[2 * pp], sh, bx[0], bx[1]);
          tc::mma(acc[2 * pp + 1], sh, bx[2], bx[3]);
          tc::mma(acc[2 * pp], sl, bx[0], bx[1]);
          tc::mma(acc[2 * pp + 1], sl, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i >= rows) continue;
        bf16* yrow = y + ((size_t)b * S + t0 + i) * H * P + (size_t)h * P + p0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = j * 8 + (lane & 3) * 2;
          const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
          if (c + 1 < pw && (P & 1) == 0) {
            *reinterpret_cast<uint32_t*>(yrow + c) = tc::pack_bf16(v0, v1);
          } else {
            if (c < pw) yrow[c] = __float2bfloat16(v0);
            if (c + 1 < pw) yrow[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();                 // C and the state parts are read
    if (ch + 1 < n_chunks) {         // the next C loads during the update
      load_rows(m.c, L.np, L.ns, cb, cst, t0 + Q, next_rows, L.Qp, N, vec);
      tc::cp_async_commit();
    }

    // S <- exp(cum_last) S + x^T (B o w), w_j = exp(cum_last - cum_j) dt_j,
    // with B o w as its high part plus its low part
    if (owns) {
      const float decay = expf(cum_last);
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        st[nt][0] *= decay;
        st[nt][1] *= decay;
        st[nt][2] *= decay;
        st[nt][3] *= decay;
      }
      for (int jk = 0; jk * 16 < rows; ++jk) {   // later rows are zero
        uint32_t xa[4];              // x^T: rows p of the warp, columns j
        tc::ldsm_x4_t(xa, sx + tc::tile_off(
                                  jk * 16 + (lane & 7) + (lane >> 4) * 8,
                                  warp * 16 + ((lane >> 3) & 1) * 8, L.xp,
                                  L.xs));
        const int jb = jk * 16 + (lane & 3) * 2;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jb + (e & 1) + (e >> 1) * 8;
          w[e] = expf(cum_last - scum[j]) * sdt[j];
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nks) continue;
          uint32_t bw[4], hi[4], lo[4];
          tc::ldsm_x4_t(bw, sb + tc::tile_off(
                                    jk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    ks * 16 + (lane >> 4) * 8, L.np, L.ns));
#pragma unroll
          for (int r = 0; r < 4; ++r)   // b0/b2: j = jb, jb+1; b1/b3: +8
            tc::scale_split_bf16(bw[r], w[(r & 1) * 2], w[(r & 1) * 2 + 1],
                                 hi[r], lo[r]);
          tc::mma(st[2 * ks], xa, hi[0], hi[1]);
          tc::mma(st[2 * ks + 1], xa, hi[2], hi[3]);
          tc::mma(st[2 * ks], xa, lo[0], lo[1]);
          tc::mma(st[2 * ks + 1], xa, lo[2], lo[3]);
        }
      }
      publish_state(st, m, L, pr, lane);
    }
  }

  if (owns) {
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pr + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
        if (p < pw && n < N)
          final_state[state_off + (size_t)p * N + n] = st[nt][e];
      }
    }
  }
}

template <int NTN>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* init, void* y, void* final_state,
              void* states, int B, int S, int H, int P, int N, int Q,
              long long xsb, long long xst, long long bsb, long long bst,
              long long csb, long long cst, void* stream) {
  const TcLayout L = tc_layout(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc<NTN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int vec = P % 8 == 0 && N % 8 == 0 &&
                  (xsb | xst | bsb | bst | csb | cst) % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  const int blocks = B * H * ((P + kSliceP - 1) / kSliceP);
  ssd_scan_tc<NTN><<<blocks, kTcThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const float*)init, (bf16*)y, (float*)final_state,
      (float*)states, S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: scalar kernels
// ---------------------------------------------------------------------------

template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The carry pass's dynamic shared memory for a block of P columns: dy's
// columns and C for one chunk, the carried gradient, dt, cum, exp(cum).
size_t carry_smem_bytes(int Q, int P, int N) {
  return sizeof(float) * ((size_t)Q * (P + 1) + (size_t)Q * (N + 1) +
                          (size_t)P * (N + 1) + 3 * (size_t)Q);
}

// Columns of P a block of the carry pass owns (as f32_slice).
int carry_slice(int Q, int P, int N) {
  int w = P;
  while (w > 1 && carry_smem_bytes(Q, w, N) > kSmemLimit) w = (w + 1) / 2;
  return carry_smem_bytes(Q, w, N) <= kSmemLimit ? w : 0;
}

// The chunk pass's dynamic shared memory: two [Q][Q + 1] f32 tiles, nine
// [Q] rows (dt, cum, w, exp(cum), the row and column sums of d cum, ddt's
// direct term, dw, d(dt * A)) and a block reduction's warp sums.
size_t chunk_smem_bytes(int Q) {
  return sizeof(float) *
         (2 * (size_t)Q * (Q + 1) + 9 * (size_t)Q + kThreads / 32);
}

// Carry pass: one block per (batch, head, slice of P), chunks from last to
// first.  dS, the gradient of the state a chunk ends with, starts from
// dfinal (zeros when null); each chunk's is written to dS_all, then
//   dS <- exp(cum_last) dS + (dy o exp(cum))^T C,
// and what is left after the first chunk is the gradient of init_state.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_carry(const float* __restrict__ dy, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Cm,
              const float* __restrict__ dfinal, float* __restrict__ dS_all,
              float* __restrict__ dinit, int S, int H, int P, int N, int Q,
              int PS, long long csb, long long cst) {
  extern __shared__ float smem[];
  const int n_slices = (P + PS - 1) / PS;
  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * PS;
  const int pw = min(PS, P - p0);
  const int lg = pw + 1, ln = N + 1;
  float* sg = smem;                  // [Q][lg] dy
  float* sc = sg + Q * lg;           // [Q][ln] C
  float* sd = sc + Q * ln;           // [pw][ln] carried gradient
  float* sdt = sd + pw * ln;         // [Q]
  float* scum = sdt + Q;             // [Q]
  float* se = scum + Q;              // [Q] exp(cum)

  const int b = bh / H, h = bh - b * H, tid = threadIdx.x;
  const float a = A[h];
  const size_t row = (size_t)H * P;
  const float* gb = dy + (size_t)b * S * row + (size_t)h * P + p0;
  const float* cb = Cm + b * csb;
  const float* dtb = dt + (size_t)b * S * H + h;
  const int n_chunks = (S + Q - 1) / Q;

  for (int i = tid; i < pw * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sd[p * ln + n] = dfinal ? dfinal[((size_t)bh * P + p0) * N + i] : 0.f;
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * Q;
    __syncthreads();                 // the previous update is done
    float* out = dS_all + chunk_state_off(b, c, h, n_chunks, H, P, N) +
                 (size_t)p0 * N;
    for (int i = tid; i < pw * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      out[i] = sd[p * ln + n];
    }
    for (int i = tid; i < Q * pw; i += kThreads) {
      const int j = i / pw, p = i - j * pw, t = t0 + j;
      sg[j * lg + p] = t < S ? gb[t * row + p] : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i - j * N, t = t0 + j;
      sc[j * ln + n] = t < S ? cb[t * cst + n] : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads) {
      const int t = t0 + j;
      sdt[j] = t < S ? dtb[(size_t)t * H] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += sdt[j] * a;
        scum[j] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) se[j] = expf(scum[j]);
    __syncthreads();
    const float decay = expf(scum[Q - 1]);
    for (int i = tid; i < pw * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float v = 0.f;
      for (int j = 0; j < Q; ++j)
        v = fmaf(sg[j * lg + p] * se[j], sc[j * ln + n], v);
      sd[p * ln + n] = sd[p * ln + n] * decay + v;
    }
  }
  __syncthreads();
  if (dinit)
    for (int i = tid; i < pw * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      dinit[((size_t)bh * P + p0) * N + i] = sd[p * ln + n];
    }
}

// Chunk pass: one block per (batch, chunk, head), every chunk at once.
// From the chunk's x, dy, B, C, dt, the state it starts from (S_prev,
// written by the forward) and the gradient of the one it ends with (dS,
// from the carry pass):
//   dx  = scores^T dy + w o (B dS^T)   dC_h = dG B + exp(cum) o (dy S_prev)
//   dB_h = dG^T C + w o (x dS)         dG = (dy x^T) o L o dt_j
// dC_h and dB_h are this head's parts of dC and dB (summed over the heads
// by ssd_bwd_reduce, in order); ddt and this (batch, chunk)'s part of dA
// come from d cum, reverse-cumsummed into d(dt * a) by one thread.  Every
// sum runs in a fixed order: no atomics, the same bits every call.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ states,
              const float* __restrict__ dS_all, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dB_h,
              float* __restrict__ dC_h, float* __restrict__ dA_part, int S,
              int H, int P, int N, int Q, long long xsb, long long xst,
              long long bsb, long long bst, long long csb, long long cst) {
  extern __shared__ float smem[];
  const int lq = Q + 1;
  float* gl = smem;                  // [Q][lq] G o L, then scores
  float* gs = gl + Q * lq;           // [Q][lq] dy x^T, then dG
  float* sdt = gs + Q * lq;          // [Q]
  float* scum = sdt + Q;
  float* sw = scum + Q;              // exp(cum_last - cum_j) dt_j
  float* se = sw + Q;                // exp(cum_i)
  float* rowd = se + Q;              // d cum_i through rows i
  float* cold = rowd + Q;            // d cum_j through columns j (minus)
  float* direct = cold + Q;          // d dt_j through scores' dt_j
  float* dw = direct + Q;            // d w_j
  float* dda = dw + Q;               // d (dt a)_j
  float* red = dda + Q;              // [kThreads / 32]

  const int n_chunks = (S + Q - 1) / Q;
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = kThreads / 32;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const float a = A[h];
  const size_t row = (size_t)H * P;
  // token t of the chunk: x[t * xst + p], B/C[t * st + n], dy[t * row + p]
  const float* xb = x + b * xsb + t0 * xst + (size_t)h * P;
  const float* bb = Bm + b * bsb + t0 * bst;
  const float* cb = Cm + b * csb + t0 * cst;
  const float* gb = dy + ((size_t)b * S + t0) * row + (size_t)h * P;
  float* dxb = dx + ((size_t)b * S + t0) * row + (size_t)h * P;
  const size_t hn = (size_t)H * N;
  float* dbb = dB_h + ((size_t)b * S + t0) * hn + (size_t)h * N;
  float* dcb = dC_h + ((size_t)b * S + t0) * hn + (size_t)h * N;
  const size_t so = chunk_state_off(b, c, h, n_chunks, H, P, N);
  const float* sp = states + so;     // S_prev [P][N]
  const float* dsp = dS_all + so;    // dS [P][N]

  for (int j = tid; j < Q; j += kThreads) {
    sdt[j] = j < rows ? dt[((size_t)b * S + t0 + j) * H + h] : 0.f;
    rowd[j] = cold[j] = direct[j] = dw[j] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int j = 0; j < Q; ++j) {
      run += sdt[j] * a;
      scum[j] = run;
    }
  }
  __syncthreads();
  const float cum_last = scum[Q - 1];
  for (int j = tid; j < Q; j += kThreads) {
    sw[j] = expf(cum_last - scum[j]) * sdt[j];
    se[j] = expf(scum[j]);
  }
  // G o L and dy x^T on the lower triangle of the valid rows
  for (int i = tid; i < Q * Q; i += kThreads) {
    const int r = i / Q, j = i - r * Q;
    float g = 0.f, d = 0.f;
    if (j <= r && r < rows) {
      const float* cr = cb + r * cst;
      const float* br = bb + j * bst;
      for (int n = 0; n < N; ++n) g = fmaf(cr[n], br[n], g);
      const float* yr = gb + r * row;
      const float* xr = xb + j * xst;
      for (int p = 0; p < P; ++p) d = fmaf(yr[p], xr[p], d);
      g *= expf(scum[r] - scum[j]);
    }
    gl[r * lq + j] = g;
    gs[r * lq + j] = d;
  }
  __syncthreads();
  // u = (dy x^T) o G o L (d loss / d dt_j through scores) and t = u dt_j
  // (d loss / d L[i][j] times L[i][j]): row sums of t, column sums of t
  // and u, a warp a row (or column), lanes over the other index
  for (int r = warp; r < rows; r += n_warps) {
    float v = 0.f;
    for (int j = lane; j <= r; j += 32)
      v += gl[r * lq + j] * gs[r * lq + j] * sdt[j];
    v = warp_sum(v);
    if (lane == 0) rowd[r] = v;
  }
  for (int j = warp; j < rows; j += n_warps) {
    float v = 0.f;
    for (int r = j + lane; r < rows; r += 32)
      v += gl[r * lq + j] * gs[r * lq + j];
    v = warp_sum(v);
    if (lane == 0) {
      direct[j] = v;
      cold[j] = v * sdt[j];
    }
  }
  __syncthreads();
  // scores = G o L dt_j, dG = (dy x^T) o L dt_j, in place
  for (int i = tid; i < Q * Q; i += kThreads) {
    const int r = i / Q, j = i - r * Q;
    if (j <= r && r < rows) {
      gl[r * lq + j] *= sdt[j];
      gs[r * lq + j] *= expf(scum[r] - scum[j]) * sdt[j];
    }
  }
  __syncthreads();
  // dC_h rows: dG B + E, E = exp(cum_i) (dy S_prev); d cum_i += C_i . E_i
  for (int r = warp; r < rows; r += n_warps) {
    const float* yr = gb + r * row;
    const float* cr = cb + r * cst;
    float ce = 0.f;
    for (int n = lane; n < N; n += 32) {
      float v = 0.f;
      for (int j = 0; j <= r; ++j)
        v = fmaf(gs[r * lq + j], bb[j * bst + n], v);
      float e = 0.f;
      for (int p = 0; p < P; ++p)
        e = fmaf(yr[p], sp[(size_t)p * N + n], e);
      e *= se[r];
      ce = fmaf(cr[n], e, ce);
      dcb[r * hn + n] = v + e;
    }
    ce = warp_sum(ce);
    if (lane == 0) rowd[r] += ce;
  }
  // dx and dB_h rows j: scores^T dy + w (B dS^T), dG^T C + w (x dS);
  // dw_j = B_j . (x dS)_j
  for (int j = warp; j < rows; j += n_warps) {
    const float* br = bb + j * bst;
    const float* xr = xb + j * xst;
    for (int p = lane; p < P; p += 32) {
      float v = 0.f;
      for (int r = j; r < rows; ++r)
        v = fmaf(gl[r * lq + j], gb[r * row + p], v);
      float u = 0.f;
      for (int n = 0; n < N; ++n)
        u = fmaf(br[n], dsp[(size_t)p * N + n], u);
      dxb[j * row + p] = v + sw[j] * u;
    }
    float wacc = 0.f;
    for (int n = lane; n < N; n += 32) {
      float v = 0.f;
      for (int r = j; r < rows; ++r)
        v = fmaf(gs[r * lq + j], cb[r * cst + n], v);
      float u = 0.f;
      for (int p = 0; p < P; ++p)
        u = fmaf(xr[p], dsp[(size_t)p * N + n], u);
      dbb[j * hn + n] = v + sw[j] * u;
      wacc = fmaf(br[n], u, wacc);
    }
    wacc = warp_sum(wacc);
    if (lane == 0) dw[j] = wacc;
  }
  // dS . S_prev, for the decay exp(cum_last) of S_prev
  float v = 0.f;
  for (int i = tid; i < P * N; i += kThreads) v = fmaf(dsp[i], sp[i], v);
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float sdot = 0.f, wsum = 0.f;
    for (int k = 0; k < n_warps; ++k) sdot += red[k];
    for (int j = 0; j < Q; ++j) wsum = fmaf(dw[j], sw[j], wsum);
    float run = expf(cum_last) * sdot + wsum;    // d cum_last's extra
    float da = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      run += rowd[j] - cold[j] - dw[j] * sw[j];
      dda[j] = run;
      da = fmaf(sdt[j], run, da);
    }
    dA_part[((size_t)b * n_chunks + c) * H + h] = da;
  }
  __syncthreads();
  for (int j = tid; j < rows; j += kThreads)
    ddt[((size_t)b * S + t0 + j) * H + h] =
        a * dda[j] + direct[j] + dw[j] * expf(cum_last - scum[j]);
}

// dB and dC: the G parts of each token (the heads' parts, or the head
// groups' sums) summed in order, in the input dtype; dA: the (batch,
// chunk) parts of each of the H heads summed in order (block 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dB_h, const float* __restrict__ dC_h,
               const float* __restrict__ dA_part, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, long long BS,
               int G, int N, int n_parts, int H) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < BS * N) {
    const long long t = i / N;
    const int n = (int)(i - t * N);
    const float* pb = dB_h + (size_t)t * G * N + n;
    const float* pc = dC_h + (size_t)t * G * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < G; ++k) {
      sb += pb[(size_t)k * N];
      sc += pc[(size_t)k * N];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int k = 0; k < n_parts; ++k) s += dA_part[(size_t)k * H + h];
      dA[h] = s;
    }
}

int launch_bwd_f32(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const void* dfinal, const void* states, void* dS_all,
                   void* dB_h, void* dC_h, void* dA_part, void* dx, void* ddt,
                   void* dA, void* dB, void* dC, void* dinit, int B, int S,
                   int H, int P, int N, int Q, long long xsb, long long xst,
                   long long bsb, long long bst, long long csb, long long cst,
                   cudaStream_t stream) {
  const int PS = carry_slice(Q, P, N);
  const size_t smem_c = chunk_smem_bytes(Q);
  if (PS == 0 || smem_c > kSmemLimit) return (int)cudaErrorInvalidValue;
  const size_t smem_r = carry_smem_bytes(Q, PS, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_r);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (S + Q - 1) / Q;
  ssd_bwd_carry<<<B * H * ((P + PS - 1) / PS), kThreads, smem_r, stream>>>(
      (const float*)dy, (const float*)dt, (const float*)A, (const float*)Cm,
      (const float*)dfinal, (float*)dS_all, (float*)dinit, S, H, P, N, Q,
      PS, csb, cst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<<<B * n_chunks * H, kThreads, smem_c, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)dy, (const float*)states,
      (const float*)dS_all, (float*)dx, (float*)ddt, (float*)dB_h,
      (float*)dC_h, (float*)dA_part, S, H, P, N, Q, xsb, xst, bsb, bst, csb,
      cst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long BS = (long long)B * S;
  ssd_bwd_reduce<float><<<(unsigned)((BS * N + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      (const float*)dB_h, (const float*)dC_h, (const float*)dA_part,
      (float*)dB, (float*)dC, (float*)dA, BS, H, N, B * n_chunks, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: bf16 on wgmma
// ---------------------------------------------------------------------------
//
// Three passes and the ordered reduction, every tile a chunk of 128 rows
// (Q <= 128 zero-padded; rows past the sequence are zero and dt = 0 there)
// in 128B-swizzled [rows][64] bf16 boxes, the layout wgmma's descriptors
// read (hopper_tma_wgmma.cuh):
//
//   ssd_bwd_delta_wg   one warpgroup per (batch, chunk, head): the chunk's
//                      own part of the state gradient it hands back,
//                      Delta_c = (dy o exp(cum))^T C, on wgmma (m64 over
//                      P, n64 over N, k over the 128 tokens; dy^T o
//                      exp(cum) from registers as a bf16 high and low part,
//                      C from shared memory MN-major), into the slot of
//                      chunk c - 1 (c = 0: into dinit), and the chunk's
//                      decay exp(cum_last);
//   ssd_bwd_state_scan one thread per (batch, head, column pair of the
//                      state): dS_c-1 = exp(cum_last,c) dS_c + Delta_c from
//                      the last chunk (dfinal) back to the first, in f32;
//                      it writes each chunk's S_prev and dS as bf16 high and
//                      low parts in the chunk pass's tile layout (one
//                      contiguous copy a head there), its part of
//                      sum(S_prev o dS), and dinit = decay_0 dS_0 + Delta_0;
//   ssd_bwd_chunk_wg   two warpgroups per (batch, chunk, group of up to 8
//                      heads): G = C B^T once (f32 in shared memory, the
//                      masked lower triangle as three 64 x 64 tiles), then
//                      per head D = dy x^T once (three 64 x 64 tiles), and
//                        E = dy S_prev           d cum_i += e_i C_i . E_i,
//                                                dC += e_i E_i
//                        X = B dS^T              dw_j = x_j . X_j,
//                        dx = w o X + scores^T dy  (scores^T from G, L, dt
//                                                in registers, bf16 high
//                                                and low part)
//                        u = D o G o L           d cum_i, ddt's direct term
//                        dGsum += D o L dt_j     (f32, the group's sum)
//                      with the next head's tiles in flight (two stages
//                      where N <= 64; where N = 128 the next head's split
//                      states go in once E and X have read this head's);
//                      then dC += dGsum B and dB = dGsum^T C + sum_h w_h o
//                      (x_h dS_h) (x and dS read again); a warp a head then
//                      scans its d cum into ddt and its dA part.  Its
//                      copies: TMA boxes and bulk copies on mbarriers where
//                      every row start is 16-byte aligned and a chunk is 128
//                      tokens (the model's xBC slices), else cp.async;
//   ssd_bwd_reduce     the groups' dB and dC parts and the (batch, chunk)
//                      parts of dA, summed in order.
//
// Roundings: every product's bf16 inputs are exact except the f32 values
// that enter as a high plus a low bf16 part (dy o exp(cum), S_prev, dS,
// scores^T, dGsum), about 16 bits of mantissa each, as in the forward.

constexpr int kWq = 128;                  // chunk rows a tile holds
constexpr int kBoxQ = kWq * 128;          // bytes of a [128][64] bf16 box
constexpr int kBoxP = 64 * 128;           // bytes of a [64][64] bf16 box
constexpr int kGPitch = 68;               // f32 row pitch of a G tile
constexpr int kGTile = 64 * kGPitch * 4;  // bytes of a [64][68] f32 tile
constexpr int kDwThreads = 128;           // delta pass: one warpgroup
constexpr int kCwThreads = 256;           // chunk pass: two warpgroups
constexpr int kMaxGroup = 8;              // heads a chunk-pass block owns
constexpr int kWave = 132;                // blocks of one wave on an H100
// f32 rows of the chunk pass, then its six 8-byte mbarriers
constexpr int kCwRows = 12 * kWq + 64 * 65 / 2 + 4 + 12;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = hop::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Byte offset of element (row, col) of a tile of 64-column boxes of
// `box_rows` rows each, 128B-swizzled (the 16-byte chunk index XORed with
// the row mod 8; every box starts on 1024 bytes).
__host__ __device__ __forceinline__ int box_off(int row, int col,
                                                int box_rows) {
  return (col >> 6) * box_rows * 128 + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// Columns [0, width) of `rows` tokens (row stride `stride` elements, from
// `src`) into a [128][64 * nbox] box tile; the rest of the tile zero.
template <int NT>
__device__ __forceinline__ void load_box_tile(unsigned char* dst, int nbox,
                                              const bf16* src,
                                              long long stride, int rows,
                                              int width, bool vec) {
  const int chunks = nbox * 8;
  // rolled loops: the persistent sums leave few registers for addresses
  if (vec) {
#pragma unroll 1
    for (int i = threadIdx.x; i < kWq * chunks; i += NT) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const bool in = r < rows && c < width;
      tc::cp_async16(dst + box_off(r, c, kWq), in ? src + r * stride + c : src,
                     in ? 16 : 0);
    }
  } else {
    const int cols = chunks * 8;
#pragma unroll 1
    for (int i = threadIdx.x; i < kWq * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      *reinterpret_cast<bf16*>(dst + box_off(r, c, kWq)) =
          r < rows && c < width ? src[r * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// `bytes` (a multiple of 16) from `src` to `dst` by 16-byte cp.async.
template <int NT>
__device__ __forceinline__ void copy_async(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
#pragma unroll 1
  for (int i = threadIdx.x * 16; i < bytes; i += NT * 16)
    tc::cp_async16(dst + i, src + i, 16);
}

// 2^x by the SFU alone (ex2.approx.ftz: about 2 ulp, exp2(-inf) = 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// `p` as a value the compiler cannot see through: addresses and wgmma
// descriptors derived from it are computed where they are used, not
// hoisted out of the head loop (where dozens of 64-bit descriptors kept
// live beside the persistent sums would spill).
template <typename T>
__device__ __forceinline__ T* fresh(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// wgmma descriptors (hopper_tma_wgmma.cuh) of a freshly laundered
// address: each is made just before the wgmma that reads it, not all of a
// loop's ahead of it (64-bit values the persistent sums have no registers
// for).
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return hop::desc_k_sw128(fresh(p));
}
__device__ __forceinline__ uint64_t desc_mn(const void* p,
                                           uint32_t box_bytes) {
  return hop::desc_mn_sw128(fresh(p), box_bytes);
}

// One warp, lane l owning rows 4l .. 4l + 3 of a chunk: dt of its `rows`
// tokens (stride H from dtb; zero past them), cum = inclusive cumsum of
// dt * a, exp(cum) and w = exp(cum_last - cum) dt, into the f32 rows
// `sdt`, `scum`, `se`, `sw`.
__device__ __forceinline__ void chunk_rows_warp(const float* dtb, int H,
                                                int rows, float a,
                                                float* sdt, float* scum,
                                                float* se, float* sw,
                                                int lane) {
  float d[4], c[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    d[k] = j < rows ? dtb[(size_t)j * H] : 0.f;
    run += d[k] * a;
    c[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] += excl;
  const float last = __shfl_sync(0xffffffffu, c[3], 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    sdt[j] = d[k];
    scum[j] = c[k];
    se[j] = expf(c[k]);
    const float w = expf(last - c[k]) * d[k];
    sw[j] = w;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 bf16x2_at(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

size_t delta_wg_smem_bytes(int N) {
  return 1024 + (size_t)(1 + (N <= 64 ? 1 : 2)) * kBoxQ +
         sizeof(float) * 4 * kWq;
}

// One (batch, chunk, head)'s S_prev and dS as the state scan writes them
// for the chunk pass: [S hi | S lo | dS hi | dS lo], each a [64][64 NB]
// bf16 box tile (zero past P and N), the bytes a stage holds.
__host__ __device__ constexpr int split_part_bytes(int nb) {
  return nb * kBoxP;
}
__host__ __device__ constexpr int split_tile_bytes(int nb) {
  return 4 * split_part_bytes(nb);
}

// Shared memory of the chunk pass (byte offsets from the 1024-aligned
// base).  Phase 1: B and C, G's three f32 tiles, `st` stages (two where
// N <= 64) of [x | dy | the split S_prev and dS], the f32 rows and the
// mbarriers.  Phase 2 reuses G's and the stages' bytes: dGsum's high and
// low parts ([128][128] each), then [x | dS's high, low parts].
struct CwLayout {
  int nb, st;
  size_t b, c, g, xdy, stage, rows, total, gs, p2;
};

__host__ __device__ inline CwLayout cw_layout(int nb) {
  CwLayout L;
  L.nb = nb;
  L.st = nb == 1 ? 2 : 1;
  L.b = 0;
  L.c = (size_t)nb * kBoxQ;
  L.g = 2 * (size_t)nb * kBoxQ;
  L.xdy = L.g + 3 * (size_t)kGTile;
  L.stage = 2 * (size_t)kBoxQ + split_tile_bytes(nb);
  L.rows = L.xdy + L.st * L.stage;
  L.total = 1024 + L.rows + sizeof(float) * kCwRows;
  L.gs = L.g;
  L.p2 = L.g + 4 * (size_t)kBoxQ;
  return L;
}

size_t chunk_wg_smem_bytes(int N) {
  return cw_layout(N <= 64 ? 1 : 2).total;
}

// Heads a chunk-pass block owns, a divisor of H up to kMaxGroup: the
// largest where the (batch, chunk, head) triples make at most a wave,
// else the one whose blocks (one an SM) fill their last wave best, the
// larger on a tie.
int chunk_wg_group(int B, int n_chunks, int H) {
  const long long bc = (long long)B * n_chunks;
  int best = 0;
  long long best_blocks = 0, best_waves = 1;
  for (int d = kMaxGroup; d >= 1; --d) {
    if (H % d) continue;
    if (bc * H <= kWave) return d;
    const long long blocks = bc * (H / d);
    const long long waves = (blocks + kWave - 1) / kWave;
    if (blocks * best_waves > best_blocks * waves) {
      best = d;
      best_blocks = blocks;
      best_waves = waves;
    }
  }
  return best;
}

template <int NB>   // 64-column boxes of N: 1 (N <= 64) or 2 (N <= 128)
__global__ void __launch_bounds__(kDwThreads)
ssd_bwd_delta_wg(const bf16* __restrict__ dy, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Cm,
                 float* __restrict__ dS_all, float* __restrict__ dinit,
                 float* __restrict__ decay, int S, int H, int P, int N,
                 int Q, long long csb, long long cst, int vec) {
  extern __shared__ unsigned char ssd_wg_raw[];
  unsigned char* const smem = align_1024(ssd_wg_raw);
  unsigned char* const sY = smem;                 // dy [128][64]
  unsigned char* const sC = smem + kBoxQ;         // C [128][64 NB]
  float* const sdt = reinterpret_cast<float*>(sC + NB * kBoxQ);
  float* const scum = sdt + kWq;
  float* const se = scum + kWq;
  float* const sw = se + kWq;
  const int n_chunks = (S + Q - 1) / Q;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long yrow = (long long)H * P;
  load_box_tile<kDwThreads>(sY, 1, dy + ((size_t)b * S + t0) * yrow +
                                       (size_t)h * P,
                            yrow, rows, P, vec);
  load_box_tile<kDwThreads>(sC, NB, Cm + b * csb + t0 * cst, cst, rows, N,
                            vec);
  tc::cp_async_commit();
  if (warp == 0)
    chunk_rows_warp(dt + ((size_t)b * S + t0) * H + h, H, rows, A[h], sdt,
                    scum, se, sw, lane);
  tc::cp_async_wait<0>();
  hop::fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    decay[((size_t)b * n_chunks + c) * H + h] = expf(scum[kWq - 1]);
  if (c == 0 && dinit == nullptr) return;     // Delta_0 feeds dinit only

  // A = dy^T o exp(cum): rows p of the warp, k = 16 tokens a step
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int jk = 0; jk < 8; ++jk) {
    uint32_t ga[4];
    tc::ldsm_x4_t(ga, sY + box_off(jk * 16 + (lane & 7) + (lane >> 4) * 8,
                                   warp * 16 + ((lane >> 3) & 1) * 8, kWq));
    const int jb = jk * 16 + (lane & 3) * 2;
    const float e0 = se[jb], e1 = se[jb + 1], e8 = se[jb + 8],
                e9 = se[jb + 9];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tc::scale_split_bf16(ga[r], r < 2 ? e0 : e8, r < 2 ? e1 : e9,
                           ah[jk][r], al[jk][r]);
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  hop::wgmma_fence();
#pragma unroll
  for (int jk = 0; jk < 8; ++jk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t bd =
          desc_mn(sC + nb * kBoxQ + jk * 16 * 128, kBoxQ);
      hop::wgmma_rs(acc[nb], ah[jk], bd, 1);
      hop::wgmma_rs(acc[nb], al[jk], bd, 1);
    }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hop::fence_regs(acc[nb]);

  float* out = c > 0 ? dS_all + chunk_state_off(b, c - 1, h, n_chunks, H,
                                                P, N)
                     : dinit + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = warp * 16 + (lane >> 2) + 8 * half;
        const int n = nb * 64 + j * 8 + (lane & 3) * 2;
        if (p >= P || n >= N) continue;
        const float v0 = acc[nb][4 * j + 2 * half],
                    v1 = acc[nb][4 * j + 2 * half + 1];
        float* o = out + (size_t)p * N + n;
        if ((N & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
}

// The reverse scan over the chunks, one thread per column pair (p, n,
// n + 1) of the padded [64][64 NB] state of one (batch, head), from the
// last chunk (dS = dfinal) to the first: writes each chunk's split tile
// (S_prev from `states`, dS) for the chunk pass, and this block's part of
// sum(S_prev o dS) to sdot[b, c, h, block]; dS_c-1 = exp(cum_last,c) dS_c
// + Delta_c, where Delta_c lies in slot c - 1 of `delta`; dinit holds
// Delta_0 on entry (unless null) and the gradient of init_state on exit.
template <int NB>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_scan(const float* __restrict__ delta,
                   const float* __restrict__ states,
                   const float* __restrict__ dfinal,
                   const float* __restrict__ decay,
                   unsigned char* __restrict__ split,
                   float* __restrict__ sdot, float* __restrict__ dinit,
                   int n_chunks, int H, int P, int N) {
  __shared__ float red[kThreads / 32];
  constexpr int kPart = split_part_bytes(NB);
  const int i = blockIdx.x * kThreads + threadIdx.x;   // < 64 * 32 * NB
  const int p = i / (32 * NB), n = (i - p * (32 * NB)) * 2;
  const bool in = p < P && n < N, two = in && n + 1 < N;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t PN = (size_t)P * N, e = in ? (size_t)p * N + n : 0;
  const int off = box_off(p, n, 64);
  auto ld2 = [&](const float* m) {
    float2 v = make_float2(0.f, 0.f);
    if (two && (N & 1) == 0) {
      v = *reinterpret_cast<const float2*>(m + e);
    } else if (in) {
      v.x = m[e];
      if (two) v.y = m[e + 1];
    }
    return v;
  };
  auto at = [&](int c) { return chunk_state_off(b, c, h, n_chunks, H, P, N); };
  float2 v = dfinal ? ld2(dfinal + bh * PN) : make_float2(0.f, 0.f);
  float2 s = ld2(states + at(n_chunks - 1));
  for (int c = n_chunks - 1; c >= 0; --c) {
    float2 s_next = make_float2(0.f, 0.f), d_c = make_float2(0.f, 0.f);
    if (c > 0) {
      s_next = ld2(states + at(c - 1));
      d_c = ld2(delta + at(c - 1));
    }
    unsigned char* t =
        split + (((size_t)b * n_chunks + c) * H + h) * split_tile_bytes(NB) +
        off;
    tc::split_bf16(s.x, s.y, *reinterpret_cast<uint32_t*>(t),
                   *reinterpret_cast<uint32_t*>(t + kPart));
    tc::split_bf16(v.x, v.y, *reinterpret_cast<uint32_t*>(t + 2 * kPart),
                   *reinterpret_cast<uint32_t*>(t + 3 * kPart));
    float dot = warp_sum(fmaf(s.x, v.x, s.y * v.y));
    if (lane == 0) red[warp] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) sum += red[k];
      sdot[(((size_t)b * n_chunks + c) * H + h) * gridDim.x + blockIdx.x] =
          sum;
    }
    __syncthreads();
    if (c > 0) {
      const float dec = decay[((size_t)b * n_chunks + c) * H + h];
      v = make_float2(fmaf(dec, v.x, d_c.x), fmaf(dec, v.y, d_c.y));
      s = s_next;
    }
  }
  if (dinit && in) {
    const float dec = decay[(size_t)b * n_chunks * H + h];
    float* di = dinit + bh * PN + e;
    di[0] = fmaf(dec, v.x, di[0]);
    if (two) di[1] = fmaf(dec, v.y, di[1]);
  }
}

// d cum -> d(dt a), a warp a (batch, chunk, head): the reverse cumsum of
// the chunk pass's d cum over the chunk's rows (lane l owning rows 4 l ..
// 4 l + 3), with d cum_last's other term, exp(cum_last) sum(S_prev o dS),
// added on the last row; ddt += a d(dt a) and the (batch, chunk) part of
// dA = sum dt d(dt a).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum_scan(const float* __restrict__ dcum, const float* __restrict__ dt,
                  const float* __restrict__ A,
                  const float* __restrict__ decay,
                  const float* __restrict__ sdot, float* __restrict__ ddt,
                  float* __restrict__ dA_part, int S, int H, int Q,
                  int n_sdot, long long n_items) {
  const long long item =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (item >= n_items) return;               // a whole warp
  const int lane = threadIdx.x & 31;
  const int n_chunks = (S + Q - 1) / Q;
  const int h = (int)(item % H);
  const long long bc = item / H;
  const int c = (int)(bc % n_chunks), b = (int)(bc / n_chunks);
  const int t0 = c * Q, rows = min(Q, S - t0);
  float dc[4], suf[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    dc[k] = j < rows ? dcum[((size_t)b * S + t0 + j) * H + h] : 0.f;
    if (j == rows - 1) {
      float sd = 0.f;
      for (int i = 0; i < n_sdot; ++i) sd += sdot[item * n_sdot + i];
      dc[k] = fmaf(decay[item], sd, dc[k]);
    }
  }
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    run += dc[k];
    suf[k] = run;
  }
  float t = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, t, off);
    if (lane + off < 32) t += u;
  }
  float excl = __shfl_down_sync(0xffffffffu, t, 1);
  if (lane == 31) excl = 0.f;
  const float a = A[h];
  float da = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    if (j >= rows) continue;
    const size_t o = ((size_t)b * S + t0 + j) * H + h;
    const float dda = suf[k] + excl;
    ddt[o] = fmaf(a, dda, ddt[o]);
    da = fmaf(dt[o], dda, da);
  }
  da = warp_sum(da);
  if (lane == 0) dA_part[item] = da;
}

// Pointers and values of one chunk-pass block that the warpgroups' parts
// read.
struct CwCtx {
  const unsigned char *sB, *sC, *sx, *sy, *s_hi, *s_lo, *d_hi, *d_lo;
  const float *sG, *sdt, *scum, *se, *sw;
  float *rowdE, *rowdT, *sdw, *colp, *tri;
  int warp, lane;
};

// The lower triangle of a 64 x 64 tile, row by row: element (i, j <= i).
constexpr int kTri = 64 * 65 / 2;
__device__ __forceinline__ int tri_off(int i, int j) {
  return i * (i + 1) / 2 + j;
}

__device__ __forceinline__ float g_at(const float* sG, int i, int j) {
  return sG[((i >> 6) + (j >> 6)) * (64 * kGPitch) + (i & 63) * kGPitch +
            (j & 63)];
}

// acc[nb] += w_j (x dS)[rows R] for one head: dB's head term (x and dS
// from the phase-2 stage)
template <int W, int NB>
__device__ __forceinline__ void db_head_term(float (&acc)[NB][32],
                                             const unsigned char* px,
                                             const unsigned char* pd_hi,
                                             const unsigned char* pd_lo,
                                             float w0, float w1) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float X2[32];
    hop::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma_ss_t<0, 1>(
            X2, desc_k(px + W * 8192 + ks * 32),
            desc_mn((part ? pd_lo : pd_hi) + nb * kBoxP +
                               ks * 2048, kBoxP),
            part > 0 || ks > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(X2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[nb][4 * j] = fmaf(w0, X2[4 * j], acc[nb][4 * j]);
      acc[nb][4 * j + 1] = fmaf(w0, X2[4 * j + 1], acc[nb][4 * j + 1]);
      acc[nb][4 * j + 2] = fmaf(w1, X2[4 * j + 2], acc[nb][4 * j + 2]);
      acc[nb][4 * j + 3] = fmaf(w1, X2[4 * j + 3], acc[nb][4 * j + 3]);
    }
  }
}

// Warpgroup W's share of one head, rows R = [64 W, 64 W + 64), in two
// parts.  The group's sum of dG = D o L dt_j, dGsum, is kept for three
// 64 x 64 tiles, each by the warpgroup that computes its D: (1, 1) and
// (1, 0) in the registers of warpgroups 0 and 1 (dGs), (0, 0) as a lower
// triangle in shared memory (`tri`, added to by its owning threads only),
// so that no warpgroup holds more than one tile of it beside dC's sum.  The first reads S_prev and dS: E on rows i of R (dC's head term
// into dCacc, C_i . E_i) and X = B dS^T on rows j of R (dw_j; w o X starts
// dx in X).  The second reads dy, x and G: scores^T dy into X, dx stored,
// and the D tiles it owns (W = 0: (1, 1); W = 1: (0, 0) and (1, 0), which
// balances the triangle's wgmma work with dx's: three tiles each).
template <int W, int NB>
__device__ __forceinline__ void chunk_head_a(const CwCtx& m0,
                                             float (&dCacc)[NB][32],
                                             float (&X)[32]) {
  CwCtx m = m0;
  const int warp = m.warp, lane = m.lane, gq = lane >> 2, cq = lane & 3;
  const int r0 = 64 * W + 16 * warp + gq, r1 = r0 + 8;
  // ---- E = dy S_prev on rows i of R ----
  {
    m.sy = fresh(m.sy);
    m.s_hi = fresh(m.s_hi);
    m.s_lo = fresh(m.s_lo);
    float ce0 = 0.f, ce1 = 0.f;
    const float e0 = m.se[r0], e1 = m.se[r1];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float E[32];
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma_ss_t<0, 1>(
            E, desc_k(m.sy + W * 8192 + ks * 32),
            desc_mn(m.s_hi + nb * kBoxP + ks * 2048, kBoxP),
            ks > 0);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma_ss_t<0, 1>(
            E, desc_k(m.sy + W * 8192 + ks * 32),
            desc_mn(m.s_lo + nb * kBoxP + ks * 2048, kBoxP), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(E);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb * 64 + j * 8 + cq * 2;
        const float2 c0 = bf16x2_at(m.sC + box_off(r0, n, kWq));
        const float2 c1 = bf16x2_at(m.sC + box_off(r1, n, kWq));
        ce0 = fmaf(c0.x, E[4 * j], fmaf(c0.y, E[4 * j + 1], ce0));
        ce1 = fmaf(c1.x, E[4 * j + 2], fmaf(c1.y, E[4 * j + 3], ce1));
        dCacc[nb][4 * j] = fmaf(e0, E[4 * j], dCacc[nb][4 * j]);
        dCacc[nb][4 * j + 1] = fmaf(e0, E[4 * j + 1], dCacc[nb][4 * j + 1]);
        dCacc[nb][4 * j + 2] = fmaf(e1, E[4 * j + 2], dCacc[nb][4 * j + 2]);
        dCacc[nb][4 * j + 3] = fmaf(e1, E[4 * j + 3], dCacc[nb][4 * j + 3]);
      }
    }
    ce0 = quad_sum(ce0) * e0;
    ce1 = quad_sum(ce1) * e1;
    if (cq == 0) {
      m.rowdE[r0] = ce0;
      m.rowdE[r1] = ce1;
    }
  }
  // ---- X = B dS^T, dw, w o X on rows j of R ----
  {
    m.sB = fresh(m.sB);
    m.d_hi = fresh(m.d_hi);
    m.d_lo = fresh(m.d_lo);
    hop::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NB; ++ks)
      hop::wgmma_ss_t<0, 0>(
          X,
          desc_k(m.sB + (ks >> 2) * kBoxQ + W * 8192 +
                            (ks & 3) * 32),
          desc_k(m.d_hi + (ks >> 2) * kBoxP + (ks & 3) * 32),
          ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4 * NB; ++ks)
      hop::wgmma_ss_t<0, 0>(
          X,
          desc_k(m.sB + (ks >> 2) * kBoxQ + W * 8192 +
                            (ks & 3) * 32),
          desc_k(m.d_lo + (ks >> 2) * kBoxP + (ks & 3) * 32), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(X);
    float dw0 = 0.f, dw1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int p = jn * 8 + cq * 2;
      const float2 x0 = bf16x2_at(m.sx + box_off(r0, p, kWq));
      const float2 x1 = bf16x2_at(m.sx + box_off(r1, p, kWq));
      dw0 = fmaf(x0.x, X[4 * jn], fmaf(x0.y, X[4 * jn + 1], dw0));
      dw1 = fmaf(x1.x, X[4 * jn + 2], fmaf(x1.y, X[4 * jn + 3], dw1));
    }
    dw0 = quad_sum(dw0);
    dw1 = quad_sum(dw1);
    if (cq == 0) {
      m.sdw[r0] = dw0;
      m.sdw[r1] = dw1;
    }
    const float w0 = m.sw[r0], w1 = m.sw[r1];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      X[4 * jn] *= w0;
      X[4 * jn + 1] *= w0;
      X[4 * jn + 2] *= w1;
      X[4 * jn + 3] *= w1;
    }
  }
}

template <int W, int NB>
__device__ __forceinline__ void chunk_head_b(
    const CwCtx& m0, float (&dGs)[32], float (&X)[32],
    bf16* __restrict__ dxr, long long xrow_out, int rows, int P) {
  CwCtx m = m0;
  const int warp = m.warp, lane = m.lane, gq = lane >> 2, cq = lane & 3;
  const int r0 = 64 * W + 16 * warp + gq, r1 = r0 + 8;
  // ---- dx = w o X + scores^T dy on rows j of R ----
  {
    m.sy = fresh(m.sy);
    const float cj0 = m.scum[r0] * kLog2e, cj1 = m.scum[r1] * kLog2e;
    const float dj0 = m.sdt[r0], dj1 = m.sdt[r1];
    // k over the i >= 64 W, two k-steps (32 i) a batch
#pragma unroll
    for (int kb = 2 * W; kb < 4; ++kb) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ib = 32 * kb + 16 * kk + cq * 2;
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // a0/a2: row r0, a1/a3: row r1
          const int j = r & 1 ? r1 : r0;
          const float cj = r & 1 ? cj1 : cj0, dj = r & 1 ? dj1 : dj0;
          const int i = ib + (r >> 1) * 8;
          const float v0 =
              i >= j ? g_at(m.sG, i, j) *
                           exp2_sfu(fmaf(m.scum[i], kLog2e, -cj)) * dj
                     : 0.f;
          const float v1 =
              i + 1 >= j ? g_at(m.sG, i + 1, j) *
                               exp2_sfu(fmaf(m.scum[i + 1], kLog2e, -cj)) *
                               dj
                         : 0.f;
          tc::split_bf16(v0, v1, ah[kk][r], al[kk][r]);
        }
      }
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bd =
            desc_mn(m.sy + (32 * kb + 16 * kk) * 128, kBoxQ);
        hop::wgmma_rs(X, ah[kk], bd, 1);
        hop::wgmma_rs(X, al[kk], bd, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(X);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = half ? r1 : r0;
      if (j >= rows) continue;
      bf16* xr = dxr + (long long)j * xrow_out;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int p = jn * 8 + cq * 2;
        const float v0 = X[4 * jn + 2 * half], v1 = X[4 * jn + 2 * half + 1];
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<uint32_t*>(xr + p) = tc::pack_bf16(v0, v1);
        } else {
          if (p < P) xr[p] = __float2bfloat16(v0);
          if (p + 1 < P) xr[p + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
  // ---- the D tiles: u = D o G o L and dGsum += D o L dt_j ----
  {
    m.sy = fresh(m.sy);
    m.sx = fresh(m.sx);
    constexpr int TJ = W == 0 ? 1 : 0;         // column block of its tiles
    constexpr int NT = W == 0 ? 1 : 2;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int ti = W == 0 ? 1 : k;
      float Dt[32];
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hop::wgmma_ss_t<0, 0>(
            Dt, desc_k(m.sy + ti * 8192 + ks * 32),
            desc_k(m.sx + TJ * 8192 + ks * 32), ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(Dt);
      const int i0 = 64 * ti + 16 * warp + gq, i1 = i0 + 8;
      const float ci0 = m.scum[i0] * kLog2e, ci1 = m.scum[i1] * kLog2e;
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float colp[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const int j = 64 * TJ + jn * 8 + cq * 2 + (e & 1);
          if (j > i) continue;
          const float l =
              exp2_sfu((e < 2 ? ci0 : ci1) - m.scum[j] * kLog2e);
          const float dtj = m.sdt[j], D = Dt[4 * jn + e];
          const float u = D * g_at(m.sG, i, j) * l;
          if (e < 2)
            ra = fmaf(u, dtj, ra);
          else
            rb = fmaf(u, dtj, rb);
          colp[e & 1] += u;
          if (W == 1 && k == 0)     // tile (0, 0): the shared triangle
            m.tri[tri_off(i, j)] = fmaf(D * l, dtj, m.tri[tri_off(i, j)]);
          else
            dGs[4 * jn + e] = fmaf(D * l, dtj, dGs[4 * jn + e]);
        }
        // the warp's sums of these two columns; a second tile (the same
        // columns) adds on
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = colp[q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          float* dst = m.colp + warp * kWq + 64 * TJ + jn * 8 + cq * 2 + q;
          if (gq == 0) *dst = k ? *dst + v : v;
        }
      }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      if (cq == 0) {
        m.rowdT[W * kWq + i0] = ra;
        m.rowdT[W * kWq + i1] = rb;
      }
    }
  }
}

// dGsum's tiles of warpgroup W into [128 i][128 j] high and low boxes
// dGsum's tiles of warpgroup W into [128 i][128 j] high and low boxes
// (tile (0, 1) is never read; (0, 0)'s upper triangle is written zero)
template <int W>
__device__ __forceinline__ void store_dgsum(const float (&dGs)[32],
                                            const float* tri,
                                            unsigned char* gs_hi,
                                            unsigned char* gs_lo, int warp,
                                            int lane) {
  constexpr int NT = W == 0 ? 1 : 2;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int ti = W == 0 ? 1 : 1 - k, tj = W == 0 ? 1 : 0;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int il = 16 * warp + (lane >> 2) + 8 * half;
        const int jl = jn * 8 + (lane & 3) * 2;
        float v0 = dGs[4 * jn + 2 * half], v1 = dGs[4 * jn + 2 * half + 1];
        if (W == 1 && k == 1) {     // tile (0, 0), from the triangle
          v0 = jl <= il ? tri[tri_off(il, jl)] : 0.f;
          v1 = jl + 1 <= il ? tri[tri_off(il, jl + 1)] : 0.f;
        }
        const int off = box_off(64 * ti + il, 64 * tj + jl, kWq);
        tc::split_bf16(v0, v1, *reinterpret_cast<uint32_t*>(gs_hi + off),
                       *reinterpret_cast<uint32_t*>(gs_lo + off));
      }
  }
}

// acc[nb] += dGsum[rows R] B (W = 0: k over j < 64, where dGsum's upper
// tile is zero; W = 1: all 128)
template <int W, int NB>
__device__ __forceinline__ void dc_from_dgsum(float (&acc)[NB][32],
                                              const unsigned char* gs_hi,
                                              const unsigned char* gs_lo,
                                              const unsigned char* sB) {
  constexpr int KS = W == 0 ? 4 : 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    hop::fence_regs(acc[nb]);
    hop::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hop::wgmma_ss_t<0, 1>(
            acc[nb],
            desc_k((part ? gs_lo : gs_hi) + (ks >> 2) * kBoxQ +
                              W * 8192 + (ks & 3) * 32),
            desc_mn(sB + nb * kBoxQ + ks * 2048, kBoxQ), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc[nb]);
  }
}

// acc[nb] = dGsum^T[rows R] C, k over i >= 64 W (dGsum^T read MN-major)
template <int W, int NB>
__device__ __forceinline__ void db_from_dgsum(float (&acc)[NB][32],
                                              const unsigned char* gs_hi,
                                              const unsigned char* gs_lo,
                                              const unsigned char* sC) {
  constexpr int K0 = W == 0 ? 0 : 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    hop::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int ks = K0; ks < 8; ++ks)
        hop::wgmma_ss_t<1, 1>(
            acc[nb],
            desc_mn((part ? gs_lo : gs_hi) + W * kBoxQ +
                               ks * 2048, kBoxQ),
            desc_mn(sC + nb * kBoxQ + ks * 2048, kBoxQ),
            part > 0 || ks > K0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc[nb]);
  }
}

// rows r0 and r0 + 8 (those below `rows`) of acc[NB] into the f32 rows of
// `out` (row stride `stride`), columns below N
template <int NB>
__device__ __forceinline__ void store_f32_rows(float* out, long long stride,
                                               const float (&acc)[NB][32],
                                               int r0, int rows, int N,
                                               int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    float* o = out + (long long)r * stride;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nb * 64 + j * 8 + (lane & 3) * 2;
        const float v0 = acc[nb][4 * j + 2 * half],
                    v1 = acc[nb][4 * j + 2 * half + 1];
        if ((N & 1) == 0 && n + 1 < N) {
          *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
        } else {
          if (n < N) o[n] = v0;
          if (n + 1 < N) o[n + 1] = v1;
        }
      }
  }
}

template <int NB>
__global__ void __launch_bounds__(kCwThreads, 1)
ssd_bwd_chunk_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                 const unsigned char* __restrict__ split,
                 bf16* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dcum, float* __restrict__ dB_g,
                 float* __restrict__ dC_g, int S, int H, int P, int N,
                 int Q, int HG, long long xsb,
                 long long xst, long long bsb, long long bst, long long csb,
                 long long cst, int vec, int tma,
                 const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_dy,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c) {
  constexpr int ST = NB == 1 ? 2 : 1;
  constexpr int kPart = split_part_bytes(NB);
  const CwLayout L = cw_layout(NB);
  extern __shared__ unsigned char ssd_wg_raw[];
  unsigned char* const smem = align_1024(ssd_wg_raw);
  unsigned char* const sB = smem + L.b;
  unsigned char* const sC = smem + L.c;
  float* const sG = reinterpret_cast<float*>(smem + L.g);
  float* const rw = reinterpret_cast<float*>(smem + L.rows);
  float* const sdt = rw;
  float* const scum = rw + kWq;
  float* const se = rw + 2 * kWq;
  float* const sw = rw + 3 * kWq;
  float* const rowdE = rw + 4 * kWq;
  float* const rowdT = rw + 5 * kWq;        // [2][128]
  float* const sdw = rw + 7 * kWq;
  float* const colp = rw + 8 * kWq;         // [4][128]
  float* const tri = rw + 12 * kWq;         // [kTri] dGsum's tile (0, 0)
  float* const wpart = tri + kTri;          // [4] a warp's w . dw
  // the TMA route's mbarriers: B and C; each stage's x and dy, and its
  // split states; phase 2's x and dS
  uint64_t* const bar_bc = reinterpret_cast<uint64_t*>(wpart + 4);
  uint64_t* const bar_xy = bar_bc + 1;
  uint64_t* const bar_sp = bar_xy + 2;
  uint64_t* const bar_p2 = bar_sp + 2;
  constexpr int kBars = 6;

  const int n_chunks = (S + Q - 1) / Q, n_groups = H / HG;
  const int g = blockIdx.x % n_groups, bc = blockIdx.x / n_groups;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const long long yrow = (long long)H * P;
  const bf16* const xb = x + b * xsb + t0 * xst;
  const bf16* const yb = dy + ((size_t)b * S + t0) * yrow;
  auto split_of = [&](int h) {
    return split + (((size_t)b * n_chunks + c) * H + h) * (4 * kPart);
  };
  // stage s: x, dy, then S_prev and dS (hi, lo each) as the scan split them
  auto stage_x = [&](int s) { return smem + L.xdy + s * L.stage; };
  // The two copy routes (chosen on the host from the layout): TMA boxes
  // and one bulk copy, issued by thread 0 and awaited on mbarriers; or
  // every thread's cp.async, awaited by wait_group.  Either way a stage is
  // refilled only after a block barrier that follows its last read.
  auto issue_xy = [&](int s, int h) {
    if (!tma) {
      load_box_tile<kCwThreads>(stage_x(s), 1, xb + (size_t)h * P, xst, rows,
                                P, vec);
      load_box_tile<kCwThreads>(stage_x(s) + kBoxQ, 1, yb + (size_t)h * P,
                                yrow, rows, P, vec);
    } else if (tid == 0) {
      hop::mbar_arrive_expect_tx(&bar_xy[s], 2 * kBoxQ);
      hop::tma_load_4d(stage_x(s), &tm_x, &bar_xy[s], 0, h, t0, b);
      hop::tma_load_4d(stage_x(s) + kBoxQ, &tm_dy, &bar_xy[s], 0, h, t0, b);
    }
  };
  auto issue_sp = [&](int s, int h) {
    if (!tma) {
      copy_async<kCwThreads>(stage_x(s) + 2 * kBoxQ, split_of(h), 4 * kPart);
    } else if (tid == 0) {
      hop::mbar_arrive_expect_tx(&bar_sp[s], 4 * kPart);
      hop::bulk_load(stage_x(s) + 2 * kBoxQ, split_of(h), 4 * kPart,
                     &bar_sp[s]);
    }
  };

  if (tma && tid == 0) {
    for (int i = 0; i < kBars; ++i) hop::mbar_init(&bar_bc[i], 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  if (!tma) {
    load_box_tile<kCwThreads>(sB, NB, Bm + b * bsb + t0 * bst, bst, rows, N,
                              vec);
    load_box_tile<kCwThreads>(sC, NB, Cm + b * csb + t0 * cst, cst, rows, N,
                              vec);
  } else if (tid == 0) {
    hop::mbar_arrive_expect_tx(bar_bc, 2 * NB * kBoxQ);
    for (int nb = 0; nb < NB; ++nb) {
      hop::tma_load_3d(sB + nb * kBoxQ, &tm_b, bar_bc, 64 * nb, t0, b);
      hop::tma_load_3d(sC + nb * kBoxQ, &tm_c, bar_bc, 64 * nb, t0, b);
    }
  }
  issue_xy(0, g * HG);
  issue_sp(0, g * HG);
  if (tma) {
    hop::mbar_wait(bar_bc, 0);
  } else {
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    hop::fence_proxy_async();
    __syncthreads();
  }
  {  // G = C B^T: warpgroup 0 the tile (1, 1), 1 the tiles (0, 0), (1, 0)
    const int nt = wg == 0 ? 1 : 2;
    for (int k = 0; k < nt; ++k) {
      const int ti = wg == 0 ? 1 : k, tj = wg == 0 ? 1 : 0;
      float acc[32];
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NB; ++ks)
        hop::wgmma_ss_t<0, 0>(
            acc,
            desc_k(sC + (ks >> 2) * kBoxQ + ti * 8192 +
                              (ks & 3) * 32),
            desc_k(sB + (ks >> 2) * kBoxQ + tj * 8192 +
                              (ks & 3) * 32),
            ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      float* tile = sG + (ti + tj) * (64 * kGPitch);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int il = 16 * warp + (lane >> 2) + 8 * half;
          *reinterpret_cast<float2*>(tile + il * kGPitch + j * 8 +
                                     (lane & 3) * 2) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
    }
  }

  float dCacc[NB][32], dGs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) dCacc[nb][i] = 0.f;
    dGs[i] = 0.f;
  }
  for (int i = tid; i < kTri; i += kCwThreads) tri[i] = 0.f;
  const long long grow = (long long)n_groups * N;   // a token of dB_g/dC_g
  for (int hh = 0; hh < HG; ++hh) {
    const int h = g * HG + hh, st = ST == 2 ? (hh & 1) : 0;
    if (ST == 2 && hh + 1 < HG) {
      issue_xy(st ^ 1, h + 1);
      issue_sp(st ^ 1, h + 1);
      if (!tma) tc::cp_async_commit();
    }
    if (tid < 32)
      chunk_rows_warp(dt + ((size_t)b * S + t0) * H + h, H, rows, A[h], sdt,
                      scum, se, sw, lane);
    if (tma) {
      hop::mbar_wait(&bar_xy[st], (hh / ST) & 1);
      hop::mbar_wait(&bar_sp[st], (hh / ST) & 1);
    } else if (ST == 2 && hh + 1 < HG) {
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    hop::fence_proxy_async();
    __syncthreads();
    unsigned char* const sp = stage_x(st) + 2 * kBoxQ;
    const CwCtx m{sB, sC, stage_x(st), stage_x(st) + kBoxQ, sp, sp + kPart,
                  sp + 2 * kPart, sp + 3 * kPart, sG, sdt, scum, se, sw,
                  rowdE, rowdT, sdw, colp, tri, warp, lane};
    bf16* const dxr = dx + ((size_t)b * S + t0) * yrow + (size_t)h * P;
    float X[32];
    if (wg == 0)
      chunk_head_a<0, NB>(m, dCacc, X);
    else
      chunk_head_a<1, NB>(m, dCacc, X);
    if (ST == 1) {     // the split states are read: the next head's go in
      hop::fence_proxy_async();
      __syncthreads();
      if (hh + 1 < HG) {
        issue_sp(0, h + 1);
        if (!tma) tc::cp_async_commit();
      }
    }
    if (wg == 0)
      chunk_head_b<0, NB>(m, dGs, X, dxr, yrow, rows, P);
    else
      chunk_head_b<1, NB>(m, dGs, X, dxr, yrow, rows, P);
    hop::fence_proxy_async();
    __syncthreads();
    if (ST == 1 && hh + 1 < HG) {
      issue_xy(0, h + 1);
      if (!tma) tc::cp_async_commit();
    }
    if (tid < kWq) {   // row j's d cum and ddt's terms but d(dt a)'s
      const int j = tid;
      const float dir = colp[j] + colp[kWq + j] + colp[2 * kWq + j] +
                        colp[3 * kWq + j];
      float rowd = rowdT[kWq + j] + rowdE[j];
      if (j >= 64) rowd += rowdT[j];
      const float q = sdw[j] * sw[j];
      if (j < rows) {
        const size_t o = ((size_t)b * S + t0 + j) * H + h;
        dcum[o] = rowd - dir * sdt[j] - q;
        ddt[o] = dir +
                 sdw[j] * exp2_sfu((scum[kWq - 1] - scum[j]) * kLog2e);
      }
      const float qs = warp_sum(q);
      if (lane == 0) wpart[tid >> 5] = qs;
    }
    hop::fence_proxy_async();
    __syncthreads();
    if (tid == 0)      // d cum_last's w . dw, on the chunk's last row
      dcum[((size_t)b * S + t0 + rows - 1) * H + h] +=
          wpart[0] + wpart[1] + wpart[2] + wpart[3];
  }

  // ---- phase 2: dC += dGsum B; dB = dGsum^T C + sum_h w_h o (x_h dS_h),
  // the last in a second pass over the heads (beside dC's sum and dGsum,
  // registers have no room for dB's in the first) ----
  unsigned char* const gs_hi = smem + L.gs;
  unsigned char* const gs_lo = gs_hi + 2 * kBoxQ;
  if (wg == 0)
    store_dgsum<0>(dGs, tri, gs_hi, gs_lo, warp, lane);
  else
    store_dgsum<1>(dGs, tri, gs_hi, gs_lo, warp, lane);
  unsigned char* const p2 = smem + L.p2;      // x, then dS's hi, lo parts
  auto issue_xd = [&](int h) {
    if (!tma) {
      load_box_tile<kCwThreads>(p2, 1, xb + (size_t)h * P, xst, rows, P,
                                vec);
      copy_async<kCwThreads>(p2 + kBoxQ, split_of(h) + 2 * kPart,
                             2 * kPart);
      tc::cp_async_commit();
    } else if (tid == 0) {
      hop::mbar_arrive_expect_tx(bar_p2, kBoxQ + 2 * kPart);
      hop::tma_load_4d(p2, &tm_x, bar_p2, 0, h, t0, b);
      hop::bulk_load(p2 + kBoxQ, split_of(h) + 2 * kPart, 2 * kPart,
                     bar_p2);
    }
  };
  issue_xd(g * HG);
  hop::fence_proxy_async();
  __syncthreads();
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  if (wg == 0)
    dc_from_dgsum<0, NB>(dCacc, gs_hi, gs_lo, sB);
  else
    dc_from_dgsum<1, NB>(dCacc, gs_hi, gs_lo, sB);
  store_f32_rows<NB>(dC_g + ((size_t)b * S + t0) * grow + (size_t)g * N,
                     grow, dCacc, r0, rows, N, lane);
  float dBacc[NB][32];
  if (wg == 0)
    db_from_dgsum<0, NB>(dBacc, gs_hi, gs_lo, sC);
  else
    db_from_dgsum<1, NB>(dBacc, gs_hi, gs_lo, sC);
  for (int hh = 0; hh < HG; ++hh) {
    const int h = g * HG + hh;
    if (tid < 32)       // w of this head again
      chunk_rows_warp(dt + ((size_t)b * S + t0) * H + h, H, rows, A[h],
                      sdt, scum, se, sw, lane);
    if (tma)
      hop::mbar_wait(bar_p2, hh & 1);
    else
      tc::cp_async_wait<0>();
    hop::fence_proxy_async();
    __syncthreads();
    const float w0 = sw[r0], w1 = sw[r0 + 8];
    if (wg == 0)
      db_head_term<0, NB>(dBacc, p2, p2 + kBoxQ, p2 + kBoxQ + kPart, w0,
                          w1);
    else
      db_head_term<1, NB>(dBacc, p2, p2 + kBoxQ, p2 + kBoxQ + kPart, w0,
                          w1);
    hop::fence_proxy_async();
    __syncthreads();
    if (hh + 1 < HG) issue_xd(h + 1);
  }
  store_f32_rows<NB>(dB_g + ((size_t)b * S + t0) * grow + (size_t)g * N,
                     grow, dBacc, r0, rows, N, lane);
}

template <int NB>
int launch_bwd_wg(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* dy,
                  const void* dfinal, const void* states, void* dS_all,
                  void* dB_g, void* dC_g, void* dA_part, void* decay,
                  void* split, void* sdot, void* dcum, void* dx, void* ddt,
                  void* dA, void* dB, void* dC, void* dinit, int B, int S,
                  int H,
                  int P, int N, int Q, long long xsb, long long xst,
                  long long bsb, long long bst, long long csb, long long cst,
                  cudaStream_t stream) {
  if (P > 64 || N > 64 * NB || Q > kWq || !decay || !split || !sdot ||
      !dcum || (uintptr_t)split % 16)
    return (int)cudaErrorInvalidValue;
  const size_t s_d = delta_wg_smem_bytes(N), s_c = chunk_wg_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_delta_wg<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_d);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_wg<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_c);
  if (err != cudaSuccess) return (int)err;
  const long long row = (long long)H * P;
  const int vec = P % 8 == 0 && N % 8 == 0 &&
                  (xsb | xst | bsb | bst | csb | cst | row) % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm |
                   (uintptr_t)dy) % 16 == 0;
  const int n_chunks = (S + Q - 1) / Q;
  const int HG = chunk_wg_group(B, n_chunks, H);
  // the chunk pass's copy route: TMA where every row start is 16-byte
  // aligned and a chunk fills its 128-row tiles (a box would otherwise
  // bring the next chunk's rows), else cp.async
  const int tma = vec && Q == kWq;
  CUtensorMap tm_x{}, tm_dy{}, tm_b{}, tm_c{};
  if (tma) {
    const cuuint32_t box4[4] = {64, 1, (cuuint32_t)kWq, 1};
    const cuuint32_t box3[3] = {64, (cuuint32_t)kWq, 1};
    const cuuint64_t dx4[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)B};
    const cuuint64_t sx[3] = {2ull * P, 2ull * xst, 2ull * xsb};
    const cuuint64_t sy[3] = {2ull * P, 2ull * row, 2ull * row * S};
    const cuuint64_t dn3[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t sb[2] = {2ull * bst, 2ull * bsb};
    const cuuint64_t sc[2] = {2ull * cst, 2ull * csb};
    int e = hop_host::strided_map(&tm_x, x, 4, dx4, sx, box4);
    if (!e) e = hop_host::strided_map(&tm_dy, dy, 4, dx4, sy, box4);
    if (!e) e = hop_host::strided_map(&tm_b, Bm, 3, dn3, sb, box3);
    if (!e) e = hop_host::strided_map(&tm_c, Cm, 3, dn3, sc, box3);
    if (e) return e;
  }
  ssd_bwd_delta_wg<NB><<<B * n_chunks * H, kDwThreads, s_d, stream>>>(
      (const bf16*)dy, (const float*)dt, (const float*)A, (const bf16*)Cm,
      (float*)dS_all, (float*)dinit, (float*)decay, S, H, P, N, Q, csb, cst,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_state_scan<NB><<<dim3(8 * NB, B * H), kThreads, 0, stream>>>(
      (const float*)dS_all, (const float*)states, (const float*)dfinal,
      (const float*)decay, (unsigned char*)split, (float*)sdot,
      (float*)dinit, n_chunks, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_wg<NB><<<B * n_chunks * (H / HG), kCwThreads, s_c, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const unsigned char*)split,
      (bf16*)dx, (float*)ddt, (float*)dcum, (float*)dB_g, (float*)dC_g, S,
      H, P, N, Q, HG, xsb, xst, bsb, bst, csb, cst, vec, tma, tm_x, tm_dy,
      tm_b, tm_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)B * n_chunks * H;
  ssd_bwd_dcum_scan<<<(unsigned)((items + kThreads / 32 - 1) /
                                 (kThreads / 32)),
                      kThreads, 0, stream>>>(
      (const float*)dcum, (const float*)dt, (const float*)A,
      (const float*)decay, (const float*)sdot, (float*)ddt, (float*)dA_part,
      S, H, Q, 8 * NB, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long BS = (long long)B * S;
  ssd_bwd_reduce<bf16><<<(unsigned)((BS * N + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      (const float*)dB_g, (const float*)dC_g, (const float*)dA_part,
      (bf16*)dB, (bf16*)dC, (float*)dA, BS, H / HG, N, B * n_chunks, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// forward: bf16 on wgmma, three chunk-parallel passes
// ---------------------------------------------------------------------------
//
// Replaces the same TPU kernel as `ssd_scan_tc` (src/repro/kernels/
// ssd_scan/kernel.py: `_kernel`, launched by `ssd_scan_kernel`) for bf16
// at P <= 64, N <= 128 and chunks of up to 128 tokens (every SSM arch);
// `ssd_scan_tc` keeps the other bf16 shapes (`fwd_route`).  Where the TPU
// kernel and `ssd_scan_tc` carry the state through the chunks one after
// another inside a block (at mamba2-370m's training shape 64 blocks on
// 132 SMs, each walking 32 chunks), the forward here is split as
// Mamba2's own chunked algorithm splits it -- and as the backward's
// passes above split its reverse recurrence -- so that only an f32
// elementwise scan is serial over the chunks:
//
//   ssd_fwd_state_wg   one warpgroup per (batch, chunk, head): the
//                      chunk's own end-state contribution, Delta_c =
//                      (x o w)^T B, w_j = exp(cum_last - cum_j) dt_j, on
//                      wgmma (m64 over P, n64 over N, k over the 128
//                      tokens; x^T o w from registers as a bf16 high and
//                      low part, B from shared memory MN-major), into the
//                      state slot of chunk c + 1 (the last chunk's into
//                      the final state), and the chunk's decay
//                      exp(cum_last);
//   ssd_fwd_state_scan one thread per (batch, head, column pair of the
//                      state): S_c+1 = exp(cum_last,c) S_c + Delta_c in
//                      f32 from init_state (or zeros), writing each
//                      chunk's start state (the `states` the backward
//                      reads; in place over the Deltas, and only when
//                      they are asked for) and its bf16 high and low
//                      parts as [64][64 NB] boxes for the next pass, and
//                      the final state;
//   ssd_fwd_chunk_wg   two warpgroups per (batch, chunk, group of up to 8
//                      heads, `chunk_wg_group`), each owning 64 of the
//                      chunk's rows: G = C B^T once a block, kept in the
//                      owning warpgroup's registers (its lower triangle:
//                      rows 0-63 one 64 x 64 tile, rows 64-127 two), then
//                      per head y = exp(cum_i) (C S_c^T) + scores x, the
//                      first with both operands in shared memory (S_c's
//                      high and low parts), the second with scores = G o
//                      exp(cum_i - cum_j) o dt_j (j <= i) built from G's
//                      registers as the register A operand, high and low
//                      part, and x MN-major; the next head's x and split
//                      state in flight in a second stage (TMA boxes and a
//                      bulk copy on mbarriers where every row start is
//                      16-byte aligned and a chunk is 128 tokens, else
//                      cp.async).
//
// Roundings: as `ssd_scan_tc`'s, every product's bf16 inputs are exact
// but the f32 values that go in as a high plus a low bf16 part -- x o w
// (where `ssd_scan_tc` splits B o w: the same product), the state in
// C S^T and the scores -- and the state is carried in f32.  No atomics:
// a call repeats its bits.  Bound on this card: bytes (at mamba2-370m's
// training shape the function must move 142 MB with the chunk states, 42
// us at 3.35 TB/s); the split moves more than that: the Deltas and the
// states go through device memory (67 MB each way at that shape) and the
// split states once more.

// One (batch, chunk, head)'s start state as the forward's scan writes it
// for its chunk pass: [S hi | S lo], each a [64][64 NB] bf16 box tile
// (zero past P and N).
__host__ __device__ constexpr int fwd_split_bytes(int nb) {
  return 2 * split_part_bytes(nb);
}

// Shared memory of the forward's chunk pass (byte offsets from the
// 1024-aligned base): B and C, two stages of [x | S hi | S lo], four f32
// rows of 128 and five mbarriers.
struct FcLayout {
  size_t b, c, stage, st_bytes, rows, total;
};

__host__ __device__ inline FcLayout fc_layout(int nb) {
  FcLayout L;
  L.b = 0;
  L.c = (size_t)nb * kBoxQ;
  L.stage = 2 * (size_t)nb * kBoxQ;
  L.st_bytes = kBoxQ + (size_t)fwd_split_bytes(nb);
  L.rows = L.stage + 2 * L.st_bytes;
  L.total = 1024 + L.rows + sizeof(float) * 4 * kWq + 8 * 5;
  return L;
}

size_t fwd_chunk_smem_bytes(int N) { return fc_layout(N <= 64 ? 1 : 2).total; }

// the state pass's shared memory: x, B and four f32 rows (the delta
// pass's layout)
size_t fwd_state_smem_bytes(int N) { return delta_wg_smem_bytes(N); }

template <int NB>   // 64-column boxes of N: 1 (N <= 64) or 2 (N <= 128)
__global__ void __launch_bounds__(kDwThreads)
ssd_fwd_state_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ final_state,
                 float* __restrict__ decay, int S, int H, int P, int N, int Q,
                 long long xsb, long long xst, long long bsb, long long bst,
                 int vec) {
  extern __shared__ unsigned char ssd_wg_raw[];
  unsigned char* const smem = align_1024(ssd_wg_raw);
  unsigned char* const sX = smem;                 // x [128][64]
  unsigned char* const sB = smem + kBoxQ;         // B [128][64 NB]
  float* const sdt = reinterpret_cast<float*>(sB + NB * kBoxQ);
  float* const scum = sdt + kWq;
  float* const se = scum + kWq;
  float* const sw = se + kWq;
  const int n_chunks = (S + Q - 1) / Q;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_box_tile<kDwThreads>(sX, 1, x + b * xsb + t0 * xst + (size_t)h * P,
                            xst, rows, P, vec);
  load_box_tile<kDwThreads>(sB, NB, Bm + b * bsb + t0 * bst, bst, rows, N,
                            vec);
  tc::cp_async_commit();
  if (warp == 0)
    chunk_rows_warp(dt + ((size_t)b * S + t0) * H + h, H, rows, A[h], sdt,
                    scum, se, sw, lane);
  tc::cp_async_wait<0>();
  hop::fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    decay[((size_t)b * n_chunks + c) * H + h] = expf(scum[kWq - 1]);

  // A = x^T o w: rows p of the warp, k = 16 tokens a step
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int jk = 0; jk < 8; ++jk) {
    uint32_t ga[4];
    tc::ldsm_x4_t(ga, sX + box_off(jk * 16 + (lane & 7) + (lane >> 4) * 8,
                                   warp * 16 + ((lane >> 3) & 1) * 8, kWq));
    const int jb = jk * 16 + (lane & 3) * 2;
    const float w0 = sw[jb], w1 = sw[jb + 1], w8 = sw[jb + 8],
                w9 = sw[jb + 9];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tc::scale_split_bf16(ga[r], r < 2 ? w0 : w8, r < 2 ? w1 : w9,
                           ah[jk][r], al[jk][r]);
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  hop::wgmma_fence();
#pragma unroll
  for (int jk = 0; jk < 8; ++jk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t bd = desc_mn(sB + nb * kBoxQ + jk * 16 * 128, kBoxQ);
      hop::wgmma_rs(acc[nb], ah[jk], bd, 1);
      hop::wgmma_rs(acc[nb], al[jk], bd, 1);
    }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hop::fence_regs(acc[nb]);

  float* out = c + 1 < n_chunks
                   ? states + chunk_state_off(b, c + 1, h, n_chunks, H, P, N)
                   : final_state + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = warp * 16 + (lane >> 2) + 8 * half;
        const int n = nb * 64 + j * 8 + (lane & 3) * 2;
        if (p >= P || n >= N) continue;
        const float v0 = acc[nb][4 * j + 2 * half],
                    v1 = acc[nb][4 * j + 2 * half + 1];
        float* o = out + (size_t)p * N + n;
        if ((N & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
}

// The scan over the chunks, one thread per column pair (p, n, n + 1) of
// the padded [64][64 NB] state of one (batch, head), from init_state (or
// zeros) at the first chunk to the last: S_c+1 = decay_c S_c + Delta_c,
// Delta_c read from slot c + 1 of `states` (the last chunk's from
// `final_state`).  Writes each chunk's start state into its slot (when
// `write_states`; the Delta there is read first), its split tile, and the
// final state.
template <int NB>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_state_scan(float* __restrict__ states,
                   const float* __restrict__ init,
                   float* __restrict__ final_state,
                   const float* __restrict__ decay,
                   unsigned char* __restrict__ split, int n_chunks, int H,
                   int P, int N, int write_states) {
  constexpr int kPart = split_part_bytes(NB);
  const int i = blockIdx.x * kThreads + threadIdx.x;   // < 64 * 32 * NB
  const int p = i / (32 * NB), n = (i - p * (32 * NB)) * 2;
  const bool in = p < P && n < N, two = in && n + 1 < N;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t PN = (size_t)P * N, e = in ? (size_t)p * N + n : 0;
  const int off = box_off(p, n, 64);
  auto ld2 = [&](const float* m) {
    float2 v = make_float2(0.f, 0.f);
    if (two && (N & 1) == 0) {
      v = *reinterpret_cast<const float2*>(m + e);
    } else if (in) {
      v.x = m[e];
      if (two) v.y = m[e + 1];
    }
    return v;
  };
  auto st2 = [&](float* m, float2 v) {
    if (two && (N & 1) == 0) {
      *reinterpret_cast<float2*>(m + e) = v;
    } else if (in) {
      m[e] = v.x;
      if (two) m[e + 1] = v.y;
    }
  };
  auto delta_of = [&](int c) {
    return c + 1 < n_chunks
               ? states + chunk_state_off(b, c + 1, h, n_chunks, H, P, N)
               : final_state + bh * PN;
  };
  const float* const dec = decay + (size_t)b * n_chunks * H + h;
  float2 s = init ? ld2(init + bh * PN) : make_float2(0.f, 0.f);
  float2 d = ld2(delta_of(0));
  float a = dec[0];
  for (int c = 0; c < n_chunks; ++c) {
    float2 d_next = make_float2(0.f, 0.f);
    float a_next = 0.f;
    if (c + 1 < n_chunks) {          // the next chunk's, loaded ahead
      d_next = ld2(delta_of(c + 1));
      a_next = dec[(size_t)(c + 1) * H];
    }
    if (write_states)
      st2(states + chunk_state_off(b, c, h, n_chunks, H, P, N), s);
    unsigned char* t =
        split + (((size_t)b * n_chunks + c) * H + h) * fwd_split_bytes(NB) +
        off;
    tc::split_bf16(s.x, s.y, *reinterpret_cast<uint32_t*>(t),
                   *reinterpret_cast<uint32_t*>(t + kPart));
    s = make_float2(fmaf(a, s.x, d.x), fmaf(a, s.y, d.y));
    d = d_next;
    a = a_next;
  }
  st2(final_state + bh * PN, s);
}

// Warpgroup W's rows of one head: y = exp(cum_i) (C S^T) + scores x,
// scores from G's registers (W = 0: g[0], the tile (0, 0); W = 1: g[0]
// and g[1], the tiles (1, 0) and (1, 1)), stored to rows i0, i0 + 8 of
// `yr` (row stride `yrow`) below `rows`, columns below P.
template <int W, int NB>
__device__ __forceinline__ void fwd_chunk_head(
    const float (&g)[2][32], const unsigned char* sC,
    const unsigned char* sx, const unsigned char* s_hi,
    const unsigned char* s_lo, const float* sdt, const float* scum,
    const float* se, bf16* __restrict__ yr, long long yrow, int rows, int P,
    int warp, int lane) {
  const int gq = lane >> 2, cq = lane & 3;
  const int i0 = 64 * W + 16 * warp + gq, i1 = i0 + 8;
  float Y[32];
  // ---- C S^T, the state's high part then its low part ----
  hop::wgmma_fence();
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int ks = 0; ks < 4 * NB; ++ks)
      hop::wgmma_ss_t<0, 0>(
          Y, desc_k(sC + (ks >> 2) * kBoxQ + W * 8192 + (ks & 3) * 32),
          desc_k((part ? s_lo : s_hi) + (ks >> 2) * kBoxP + (ks & 3) * 32),
          part > 0 || ks > 0);
  hop::wgmma_commit();
  const float ci0 = scum[i0] * kLog2e, ci1 = scum[i1] * kLog2e;
  const float e0 = se[i0], e1 = se[i1];
  hop::wgmma_wait<0>();
  hop::fence_regs(Y);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    Y[4 * j] *= e0;
    Y[4 * j + 1] *= e0;
    Y[4 * j + 2] *= e1;
    Y[4 * j + 3] *= e1;
  }
  // ---- += scores x, two k-steps (32 tokens j) a batch, j < 64 W + 64 ----
#pragma unroll
  for (int kb = 0; kb < 2 * (W + 1); ++kb) {
    if (32 * kb >= rows) break;       // x and dt are zero there
    const float(&gt)[32] = g[kb >> 1];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kt = 2 * (kb & 1) + kk;  // the k-step within G's tile
#pragma unroll
      for (int r = 0; r < 4; ++r) {      // pack_a's order
        const int blk = 2 * kt + (r >> 1), e = 2 * (r & 1);
        const int j = 32 * kb + 16 * kk + (r >> 1) * 8 + cq * 2;
        const int i = e ? i1 : i0;
        const float ci = e ? ci1 : ci0;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v[q] = j + q <= i ? gt[4 * blk + e + q] *
                                  exp2_sfu(fmaf(scum[j + q], -kLog2e, ci)) *
                                  sdt[j + q]
                            : 0.f;
        tc::split_bf16(v[0], v[1], ah[kk][r], al[kk][r]);
      }
    }
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t bd = desc_mn(sx + (32 * kb + 16 * kk) * 128, kBoxQ);
      hop::wgmma_rs(Y, ah[kk], bd, 1);
      hop::wgmma_rs(Y, al[kk], bd, 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(Y);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? i1 : i0;
    if (i >= rows) continue;
    bf16* row = yr + (long long)i * yrow;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int p = jn * 8 + cq * 2;
      const float v0 = Y[4 * jn + 2 * half], v1 = Y[4 * jn + 2 * half + 1];
      if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<uint32_t*>(row + p) = tc::pack_bf16(v0, v1);
      } else {
        if (p < P) row[p] = __float2bfloat16(v0);
        if (p + 1 < P) row[p + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kCwThreads, 1)
ssd_fwd_chunk_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm,
                 const unsigned char* __restrict__ split,
                 bf16* __restrict__ y, int S, int H, int P, int N, int Q,
                 int HG, long long xsb, long long xst, long long bsb,
                 long long bst, long long csb, long long cst, int vec,
                 int tma, const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c) {
  constexpr int kPart = split_part_bytes(NB);
  constexpr int kSplit = fwd_split_bytes(NB);
  const FcLayout L = fc_layout(NB);
  extern __shared__ unsigned char ssd_wg_raw[];
  unsigned char* const smem = align_1024(ssd_wg_raw);
  unsigned char* const sB = smem + L.b;
  unsigned char* const sC = smem + L.c;
  float* const rw = reinterpret_cast<float*>(smem + L.rows);
  float* const sdt = rw;
  float* const scum = rw + kWq;
  float* const se = rw + 2 * kWq;
  float* const sw = rw + 3 * kWq;
  // the TMA route's mbarriers: B and C; each stage's x, its split state
  uint64_t* const bar_bc = reinterpret_cast<uint64_t*>(rw + 4 * kWq);
  uint64_t* const bar_x = bar_bc + 1;
  uint64_t* const bar_sp = bar_x + 2;

  const int n_chunks = (S + Q - 1) / Q, n_groups = H / HG;
  const int grp = blockIdx.x % n_groups, bc = blockIdx.x / n_groups;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const long long yrow = (long long)H * P;
  const bf16* const xb = x + b * xsb + t0 * xst;
  auto stage = [&](int s) { return smem + L.stage + s * L.st_bytes; };
  auto split_of = [&](int h) {
    return split + (((size_t)b * n_chunks + c) * H + h) * kSplit;
  };
  // A stage is refilled only after a block barrier that follows its last
  // read (as in the backward's chunk pass).
  auto issue = [&](int s, int h) {
    if (!tma) {
      load_box_tile<kCwThreads>(stage(s), 1, xb + (size_t)h * P, xst, rows,
                                P, vec);
      copy_async<kCwThreads>(stage(s) + kBoxQ, split_of(h), kSplit);
      tc::cp_async_commit();
    } else if (tid == 0) {
      hop::mbar_arrive_expect_tx(&bar_x[s], kBoxQ);
      hop::tma_load_4d(stage(s), &tm_x, &bar_x[s], 0, h, t0, b);
      hop::mbar_arrive_expect_tx(&bar_sp[s], kSplit);
      hop::bulk_load(stage(s) + kBoxQ, split_of(h), kSplit, &bar_sp[s]);
    }
  };

  if (tma && tid == 0) {
    for (int i = 0; i < 5; ++i) hop::mbar_init(&bar_bc[i], 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  if (!tma) {
    load_box_tile<kCwThreads>(sB, NB, Bm + b * bsb + t0 * bst, bst, rows, N,
                              vec);
    load_box_tile<kCwThreads>(sC, NB, Cm + b * csb + t0 * cst, cst, rows, N,
                              vec);
    tc::cp_async_commit();
  } else if (tid == 0) {
    hop::mbar_arrive_expect_tx(bar_bc, 2 * NB * kBoxQ);
    for (int nb = 0; nb < NB; ++nb) {
      hop::tma_load_3d(sB + nb * kBoxQ, &tm_b, bar_bc, 64 * nb, t0, b);
      hop::tma_load_3d(sC + nb * kBoxQ, &tm_c, bar_bc, 64 * nb, t0, b);
    }
  }
  issue(0, grp * HG);
  if (tma) {
    hop::mbar_wait(bar_bc, 0);
  } else {
    tc::cp_async_wait<1>();          // B and C (stage 0 may still fly)
    hop::fence_proxy_async();
    __syncthreads();
  }
  // G = C B^T, lower triangle: warpgroup 0 the tile (0, 0), warpgroup 1
  // the tiles (1, 0) and (1, 1), in registers for every head
  float g[2][32];
  const bool live = 64 * wg < rows;  // warpgroup 1 idles on short chunks
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k > wg || !live) break;
    const int ti = wg, tj = wg == 0 ? 0 : k;
    hop::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NB; ++ks)
      hop::wgmma_ss_t<0, 0>(
          g[k], desc_k(sC + (ks >> 2) * kBoxQ + ti * 8192 + (ks & 3) * 32),
          desc_k(sB + (ks >> 2) * kBoxQ + tj * 8192 + (ks & 3) * 32),
          ks > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(g[k]);
  }

  for (int hh = 0; hh < HG; ++hh) {
    const int h = grp * HG + hh, st = hh & 1;
    if (hh + 1 < HG) issue(st ^ 1, h + 1);
    if (tid < 32)
      chunk_rows_warp(dt + ((size_t)b * S + t0) * H + h, H, rows, A[h], sdt,
                      scum, se, sw, lane);
    if (tma) {
      hop::mbar_wait(&bar_x[st], (hh >> 1) & 1);
      hop::mbar_wait(&bar_sp[st], (hh >> 1) & 1);
    } else if (hh + 1 < HG) {
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    hop::fence_proxy_async();
    __syncthreads();
    const unsigned char* const sx = stage(st);
    const unsigned char* const sp = stage(st) + kBoxQ;
    bf16* const yr = y + ((size_t)b * S + t0) * yrow + (size_t)h * P;
    if (live) {
      if (wg == 0)
        fwd_chunk_head<0, NB>(g, sC, sx, sp, sp + kPart, sdt, scum, se, yr,
                              yrow, rows, P, warp, lane);
      else
        fwd_chunk_head<1, NB>(g, sC, sx, sp, sp + kPart, sdt, scum, se, yr,
                              yrow, rows, P, warp, lane);
    }
    hop::fence_proxy_async();
    __syncthreads();                 // this stage and the rows are read
  }
}

template <int NB>
int launch_fwd_wg(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* init, void* y,
                  void* final_state, void* states, void* split, void* decay,
                  int write_states, int B, int S, int H, int P, int N, int Q,
                  long long xsb, long long xst, long long bsb, long long bst,
                  long long csb, long long cst, cudaStream_t stream) {
  if (P > 64 || N > 64 * NB || Q > kWq || !states || !split || !decay ||
      (uintptr_t)split % 16)
    return (int)cudaErrorInvalidValue;
  const size_t s1 = fwd_state_smem_bytes(N), s3 = fwd_chunk_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_state_wg<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_fwd_chunk_wg<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
  if (err != cudaSuccess) return (int)err;
  const int vec = P % 8 == 0 && N % 8 == 0 &&
                  (xsb | xst | bsb | bst | csb | cst) % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
  const int n_chunks = (S + Q - 1) / Q;
  const int HG = chunk_wg_group(B, n_chunks, H);
  // the chunk pass's copy route, as the backward's: TMA where every row
  // start is 16-byte aligned and a chunk fills its 128-row tiles
  const int tma = vec && Q == kWq;
  CUtensorMap tm_x{}, tm_b{}, tm_c{};
  if (tma) {
    const cuuint32_t box4[4] = {64, 1, (cuuint32_t)kWq, 1};
    const cuuint32_t box3[3] = {64, (cuuint32_t)kWq, 1};
    const cuuint64_t dx4[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)B};
    const cuuint64_t sx[3] = {2ull * P, 2ull * xst, 2ull * xsb};
    const cuuint64_t dn3[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t sb[2] = {2ull * bst, 2ull * bsb};
    const cuuint64_t sc[2] = {2ull * cst, 2ull * csb};
    int e = hop_host::strided_map(&tm_x, x, 4, dx4, sx, box4);
    if (!e) e = hop_host::strided_map(&tm_b, Bm, 3, dn3, sb, box3);
    if (!e) e = hop_host::strided_map(&tm_c, Cm, 3, dn3, sc, box3);
    if (e) return e;
  }
  ssd_fwd_state_wg<NB><<<B * n_chunks * H, kDwThreads, s1, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (float*)states, (float*)final_state, (float*)decay, S, H, P, N, Q, xsb,
      xst, bsb, bst, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_state_scan<NB><<<dim3(8 * NB, B * H), kThreads, 0, stream>>>(
      (float*)states, (const float*)init, (float*)final_state,
      (const float*)decay, (unsigned char*)split, n_chunks, H, P, N,
      write_states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_chunk_wg<NB><<<B * n_chunks * (H / HG), kCwThreads, s3, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const unsigned char*)split, (bf16*)y, S, H, P, N, Q,
      HG, xsb, xst, bsb, bst, csb, cst, vec, tma, tm_x, tm_b, tm_c);
  return (int)cudaGetLastError();
}

// The forward's routes; kernel.py's `fwd_route` holds the same rule.
enum FwdRoute { kFwdScalar = 0, kFwdMmaSync = 1, kFwdWgmma = 2 };

int fwd_route(int dtype, int P, int N, int Q) {
  if (dtype == 0) return kFwdScalar;
  return P <= 64 && N <= 128 && Q <= kWq ? kFwdWgmma : kFwdMmaSync;
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core
// kernels, N <= 128) for x, B, C and y; dt, A, init_state and final_state
// are f32.  x [B, S, H, P] with batch stride xsb and token stride xst
// (elements; the head and P strides are P and 1); B and C [B, S, N] with
// strides (bsb, bst, 1) and (csb, cst, 1); dt [B, S, H], A [H],
// y [B, S, H, P], init_state (or null for zeros) and final_state
// [B, H, P, N] contiguous.  route: -1 the rule's (`fwd_route`), else that
// route (1, mma.sync, for any bf16 shape the rule gives wgmma, which a
// timing or a test names).  On the mma.sync and scalar routes `states`,
// unless null, receives the state each chunk starts from,
// [B, C, H, P, N] in f32 (C = ceil(S / Q)), for the backward.  The wgmma
// route (bf16, P <= 64, N <= 128, Q <= 128) needs `states` always (its
// scan's scratch; the chunk start states are written there only when
// `with_states`), `split` [B, C, H, ssd_scan_fwd_split_bytes(N)] bytes
// and `decay` [B, C, H] f32.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* final_state,
                               void* states, void* split, void* decay,
                               int dtype, int route, int with_states, int B,
                               int S, int H, int P, int N, int Q,
                               long long xsb, long long xst, long long bsb,
                               long long bst, long long csb, long long cst,
                               void* stream) {
  const int rule = fwd_route(dtype, P, N, Q);
  if (route < 0) route = rule;
  if ((route == kFwdScalar) != (dtype == 0) ||
      (route == kFwdWgmma && rule != kFwdWgmma))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(x, dt, A, Bm, Cm, init, y, final_state, states, B, S,
                      H, P, N, Q, xsb, xst, bsb, bst, csb, cst, stream);
  cudaStream_t st = (cudaStream_t)stream;
  if (route == kFwdWgmma)
    return N <= 64
               ? launch_fwd_wg<1>(x, dt, A, Bm, Cm, init, y, final_state,
                                  states, split, decay, with_states, B, S, H,
                                  P, N, Q, xsb, xst, bsb, bst, csb, cst, st)
               : launch_fwd_wg<2>(x, dt, A, Bm, Cm, init, y, final_state,
                                  states, split, decay, with_states, B, S, H,
                                  P, N, Q, xsb, xst, bsb, bst, csb, cst, st);
  if (N <= 64)
    return launch_tc<8>(x, dt, A, Bm, Cm, init, y, final_state, states, B,
                        S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst, stream);
  if (N <= 128)
    return launch_tc<16>(x, dt, A, Bm, Cm, init, y, final_state, states, B,
                         S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst,
                         stream);
  return (int)cudaErrorInvalidValue;
}

// The forward's route for a dtype and shape: 0 the scalar kernel, 1
// `ssd_scan_tc` (mma.sync), 2 the three wgmma passes.
extern "C" int ssd_scan_fwd_route(int dtype, int P, int N, int Q) {
  return fwd_route(dtype, P, N, Q);
}

// Dynamic shared memory of the wgmma forward's state pass (pass 0) and
// chunk pass (pass 1) at state size N; its scan uses none.
extern "C" long long ssd_scan_fwd_wg_smem_bytes(int N, int pass) {
  return (long long)(pass == 0 ? fwd_state_smem_bytes(N)
                               : fwd_chunk_smem_bytes(N));
}

// Bytes of one (batch, chunk, head)'s split start state, which the wgmma
// forward's scan writes for its chunk pass.
extern "C" int ssd_scan_fwd_split_bytes(int N) {
  return fwd_split_bytes(N <= 64 ? 1 : 2);
}

// Dynamic shared memory of one block: dtype 0 = the f32 kernel (a slice
// of f32_slice columns), 1 = bf16.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N, int dtype) {
  return (long long)(dtype == 0 ? smem_bytes(Q, f32_slice(Q, P, N), N)
                                : tc_layout(Q, P, N).total);
}

// Columns of P a block of the f32 kernel owns (0: the chunk does not fit).
extern "C" int ssd_scan_f32_slice(int Q, int P, int N) {
  return f32_slice(Q, P, N);
}

// The backward of ssd_scan_launch: dtype as there (x, B, C, dy, dx, dB and
// dC in it; everything else f32).  Reads x, B and C through their strides
// as the forward does; dy [B, S, H, P] and dfinal (null: zeros) contiguous,
// states [B, C, H, P, N] as the forward wrote it.  Scratch the caller
// allocates: dS_all [B, C, H, P, N], dB_g and dC_g [B, S, G, N], dA_part
// [B, C, H], all f32, G = H for f32 and H / ssd_scan_bwd_group(B, C, H)
// for bf16, which also takes decay [B, C, H] f32, split [B, C, H,
// ssd_scan_bwd_split_bytes(N)] bytes, sdot [B, C, H, 8 NB] f32, NB = 1
// for N <= 64 else 2, and dcum [B, S, H] f32 (all null for f32).  Writes
// dx [B, S, H, P], ddt [B, S, H], dA [H], dB and dC [B, S, N] and, unless
// null, dinit [B, H, P, N].  On `stream`: f32 the carry pass, the chunk
// pass and the reduction over heads; bf16 (P <= 64, N <= 128, Q <= 128)
// the delta pass, the state scan, the chunk pass and the reduction over
// head groups.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* states,
    void* dS_all, void* dB_g, void* dC_g, void* dA_part, void* decay,
    void* split, void* sdot, void* dcum, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dinit, int dtype, int B, int S, int H, int P,
    int N, int Q, long long xsb, long long xst, long long bsb, long long bst,
    long long csb, long long cst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_f32(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                          dB_g, dC_g, dA_part, dx, ddt, dA, dB, dC, dinit, B,
                          S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst, st);
  if (N <= 64)
    return launch_bwd_wg<1>(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                            dB_g, dC_g, dA_part, decay, split, sdot, dcum, dx,
                            ddt, dA, dB, dC, dinit, B, S, H, P, N, Q, xsb,
                            xst, bsb, bst, csb, cst, st);
  if (N <= 128)
    return launch_bwd_wg<2>(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                            dB_g, dC_g, dA_part, decay, split, sdot, dcum, dx,
                            ddt, dA, dB, dC, dinit, B, S, H, P, N, Q, xsb,
                            xst, bsb, bst, csb, cst, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block of the backward's first pass (pass 0:
// f32 the carry pass, a slice of ssd_scan_bwd_carry_slice columns; bf16
// the delta pass) and of its chunk pass (pass 1), for dtype 0 = f32 (the
// scalar kernels) or 1 = bf16 (the wgmma kernels).
extern "C" long long ssd_scan_bwd_smem_bytes(int Q, int P, int N, int dtype,
                                             int pass) {
  if (dtype == 1)
    return (long long)(pass == 0 ? delta_wg_smem_bytes(N)
                                 : chunk_wg_smem_bytes(N));
  return (long long)(pass == 0 ? carry_smem_bytes(Q, carry_slice(Q, P, N), N)
                               : chunk_smem_bytes(Q));
}

// Columns of P a block of the carry pass owns (0: the chunk does not fit).
extern "C" int ssd_scan_bwd_carry_slice(int Q, int P, int N) {
  return carry_slice(Q, P, N);
}

// Heads a block of the bf16 chunk pass owns and sums dB and dC over.
extern "C" int ssd_scan_bwd_group(int B, int n_chunks, int H) {
  return chunk_wg_group(B, n_chunks, H);
}

// Bytes of one (batch, chunk, head)'s split S_prev and dS, which the bf16
// backward's state scan writes for its chunk pass.
extern "C" int ssd_scan_bwd_split_bytes(int N) {
  return split_tile_bytes(N <= 64 ? 1 : 2);
}

