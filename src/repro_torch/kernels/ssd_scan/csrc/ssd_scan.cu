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
// reference's padding does.  The dtype alone picks one of two kernels:
//
// bf16 -- `ssd_scan_tc`, the four chunk products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), 4 warps a block:
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
// measures it at about 0.17 ms on an H100 SXM at 700 W, some 8x the
// bound; tools/kernel_variants.py times each part of the work (C B^T is
// under a tenth of it, so the heads do not share it).
//
// The backward (`ssd_scan_bwd_launch`) has no TPU kernel to replace: the
// reference trains by differentiating its jnp ssd_chunked
// (src/repro/models/mamba2.py).  It computes that gradient -- dx, ddt,
// dA, dB, dC and d init_state from dy and d final -- in three launches:
//
//   * carry: one block per (batch, head, slice of P) walks the chunks from
//     last to first, dS <- exp(cum_last) dS + (dy o exp(cum))^T C, writing
//     the gradient of each chunk's end state (dS_all) and leaving that of
//     init_state.  It needs the state each chunk starts from, which the
//     forward writes under autograd (`states`);
//   * chunk: one block per (batch, chunk, head) computes that chunk's dx,
//     its head's parts of dB and dC, and ddt and its part of dA through
//     d cum (the algebra above each kernel);
//   * reduce: the heads' parts of dB and dC, and the (batch, chunk) parts
//     of dA, summed in a fixed order.
//
// Nothing is summed with atomics, so two calls give the same bits (a
// resumed training run must repeat its steps).  bf16 runs the carry and
// chunk products on the tensor cores (`ssd_bwd_carry_tc`,
// `ssd_bwd_chunk_tc`: mma.sync, f32 accumulators, f32 operands split in
// two bf16 parts as in the forward), f32 the scalar `ssd_bwd_carry` and
// `ssd_bwd_chunk`.  Bound on this card: bytes.  At mamba2-370m's training
// microbatch (B = 2, S = 4096, H = 32, P = 64, N = 128) the function must
// read x, dy, B, C, dt and the f32 chunk states and write dx, ddt, dB and
// dC: 178 MB, 53 us at 3.35 TB/s, against 30.3 GFLOP of chunk products
// (31 us at the bf16 peak).  What keeps it off that bound: the chunk pass
// recomputes C B^T and dy x^T in both orientations for every head, the
// carry pass has only B * H blocks, and the heads' f32 parts of dB and dC
// go through device memory once more; chip_smoke.py measures it at about
// 1.6 ms there on an H100 SXM at 700 W.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernels
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// dB and dC: each head's part summed over the heads in order, in the
// input dtype; dA: the (batch, chunk) parts summed in order (block 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dB_h, const float* __restrict__ dC_h,
               const float* __restrict__ dA_part, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, long long BS,
               int H, int N, int n_parts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < BS * N) {
    const long long t = i / N;
    const int n = (int)(i - t * N);
    const float* pb = dB_h + (size_t)t * H * N + n;
    const float* pc = dC_h + (size_t)t * H * N + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[(size_t)h * N];
      sc += pc[(size_t)h * N];
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
      (float*)dB, (float*)dC, (float*)dA, BS, H, N, B * n_chunks);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: tensor cores (bf16)
// ---------------------------------------------------------------------------

// Carry pass for bf16: the forward kernel's state update run backwards
// over the chunks, with the forward's layout (dy in x's tiles, C in B's)
// and warp roles: warp w owns rows [16 w, 16 w + 16) of a 64-column
// slice's dS in f32 registers, never rounded from one chunk to the next.
//   dS <- exp(cum_last) dS + dy^T (C o exp(cum)),
// dy^T's A fragments by ldmatrix.trans, C's by ldmatrix.trans scaled by
// exp(cum_i) in registers and split into a high and a low bf16 part.
template <int NTN>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_carry_tc(const bf16* __restrict__ dy, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Cm,
                 const float* __restrict__ dfinal, float* __restrict__ dS_all,
                 float* __restrict__ dinit, int S, int H, int P, int N, int Q,
                 long long csb, long long cst, int vec) {
  constexpr int KS = NTN / 2;
  extern __shared__ __align__(128) unsigned char ssd_smem[];
  const TcLayout L = tc_layout(Q, P, N);
  const Smem m = carve(ssd_smem, L);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_slices = (P + kSliceP - 1) / kSliceP;
  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * kSliceP;
  const int pw = min(kSliceP, P - p0);
  const int b = bh / H, h = bh - b * H;
  const float a = A[h];
  const int nks = L.Np / 16;
  const long long row = (long long)H * P;
  const bf16* gb = dy + (size_t)b * S * row + (size_t)h * P + p0;
  const bf16* cb = Cm + b * csb;
  const float* dtb = dt + (size_t)b * S * H + h;
  bf16* sg = m.x(0);
  bf16* sc = m.b(0);
  float* sdt = m.dt(0);
  zero_cols(sg, L.Qp, pw, L.XW, L.xp, L.xs);
  zero_cols(sc, L.Qp, N, L.Np, L.np, L.ns);

  const bool owns = warp * 16 < L.XW;
  const int pr = warp * 16 + (lane >> 2);
  const size_t state_off = (size_t)bh * P * N + (size_t)p0 * N;
  float st[NTN][4];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pr + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
      st[nt][e] = dfinal && owns && p < pw && n < N
                      ? dfinal[state_off + (size_t)p * N + n] : 0.f;
    }
  }
  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * Q, rows = min(Q, S - t0);
    if (owns) {                      // the gradient this chunk ends with
      float* out = dS_all + chunk_state_off(b, ch, h, n_chunks, H, P, N) +
                   (size_t)p0 * N;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = pr + (e >> 1) * 8,
                    n = nt * 8 + (lane & 3) * 2 + (e & 1);
          if (p < pw && n < N) out[(size_t)p * N + n] = st[nt][e];
        }
      }
    }
    __syncthreads();                 // the previous chunk's tiles are read
    load_rows(sg, L.xp, L.xs, gb, row, t0, rows, L.Qp, pw, vec);
    load_rows(sc, L.np, L.ns, cb, cst, t0, rows, L.Qp, N, vec);
    load_dt(sdt, dtb, H, t0, rows, L.Qp, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    chunk_cumsum<kTcWarps>(sdt, a, m.cum, m.warp_sum, L.Qp);
    const float* scum = m.cum;
    if (!owns) continue;
    const float decay = expf(scum[L.Qp - 1]);   // padded rows add dt = 0
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      st[nt][0] *= decay;
      st[nt][1] *= decay;
      st[nt][2] *= decay;
      st[nt][3] *= decay;
    }
    for (int jk = 0; jk * 16 < rows; ++jk) {     // later rows are zero
      uint32_t ga[4];                // dy^T: rows p of the warp, columns i
      tc::ldsm_x4_t(ga, sg + tc::tile_off(
                                jk * 16 + (lane & 7) + (lane >> 4) * 8,
                                warp * 16 + ((lane >> 3) & 1) * 8, L.xp,
                                L.xs));
      const int jb = jk * 16 + (lane & 3) * 2;
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        e[q] = expf(scum[jb + (q & 1) + (q >> 1) * 8]);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nks) continue;
        uint32_t cw[4], hi[4], lo[4];
        tc::ldsm_x4_t(cw, sc + tc::tile_off(
                                  jk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8,
                                  ks * 16 + (lane >> 4) * 8, L.np, L.ns));
#pragma unroll
        for (int r = 0; r < 4; ++r)   // c0/c2: i = jb, jb+1; c1/c3: +8
          tc::scale_split_bf16(cw[r], e[(r & 1) * 2], e[(r & 1) * 2 + 1],
                               hi[r], lo[r]);
        tc::mma(st[2 * ks], ga, hi[0], hi[1]);
        tc::mma(st[2 * ks + 1], ga, hi[2], hi[3]);
        tc::mma(st[2 * ks], ga, lo[0], lo[1]);
        tc::mma(st[2 * ks + 1], ga, lo[2], lo[3]);
      }
    }
  }
  if (dinit && owns) {
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pr + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
        if (p < pw && n < N) dinit[state_off + (size_t)p * N + n] = st[nt][e];
      }
    }
  }
}

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMaxP = 64;         // P the bf16 chunk pass holds whole

// Shared-memory layout of the bf16 chunk pass: the chunk's x, dy, B and C
// as bf16 tiles (Q, P and N padded to 16, swizzled or padded as the
// forward's), S_prev and dS as [P][N] bf16 high and low parts, and eight
// f32 rows of Q (dt, cum, exp(cum), w, the row sums of d cum, ddt's direct
// term, dw, d(dt * a)) and the warps' sums.  Byte offsets.
struct BwdLayout {
  int Qp, Np, Pp, xp, xs, np, ns;
  size_t x, g, b, c, s_hi, s_lo, d_hi, d_lo, rows, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int Q, int P, int N) {
  BwdLayout L;
  L.Qp = (Q + 15) / 16 * 16;
  L.Np = (N + 15) / 16 * 16;
  L.Pp = (P + 15) / 16 * 16;
  L.xp = tc::tile_pitch(L.Pp);
  L.xs = tc::tile_swz(L.Pp);
  L.np = tc::tile_pitch(L.Np);
  L.ns = tc::tile_swz(L.Np);
  const size_t qx = sizeof(bf16) * (size_t)L.Qp * L.xp;
  const size_t qn = sizeof(bf16) * (size_t)L.Qp * L.np;
  const size_t pn = sizeof(bf16) * (size_t)L.Pp * L.np;
  L.x = 0;
  L.g = qx;
  L.b = 2 * qx;
  L.c = L.b + qn;
  L.s_hi = L.c + qn;
  L.s_lo = L.s_hi + pn;
  L.d_hi = L.s_lo + pn;
  L.d_lo = L.d_hi + pn;
  L.rows = L.d_lo + pn;
  L.total = L.rows + sizeof(float) * (8 * (size_t)L.Qp + kBwdWarps);
  return L;
}

// Rows r0 .. r0 + 15, k-step ks of a row-major tile as A fragments.
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const bf16* t,
                                       int r0, int ks, int pitch, int swz,
                                       int lane) {
  tc::ldsm_x4(f, t + tc::tile_off(r0 + (lane & 15), ks * 16 + (lane >> 4) * 8,
                                  pitch, swz));
}

// B operand of two n8-tiles (columns n0 .. n0 + 15) at k-step ks from a
// tile stored [n][k] (ldmatrix) ...
__device__ __forceinline__ void b_nk(uint32_t (&f)[4], const bf16* t, int n0,
                                     int ks, int pitch, int swz, int lane) {
  tc::ldsm_x4(f, t + tc::tile_off(n0 + (lane & 7) + (lane >> 4) * 8,
                                  ks * 16 + ((lane >> 3) & 1) * 8, pitch,
                                  swz));
}

// ... or from a tile stored [k][n] (ldmatrix.trans).
__device__ __forceinline__ void b_kn(uint32_t (&f)[4], const bf16* t, int k0,
                                     int n0, int pitch, int swz, int lane) {
  tc::ldsm_x4_t(f, t + tc::tile_off(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    n0 + (lane >> 4) * 8, pitch, swz));
}

// acc[2 q], acc[2 q + 1] += a * b for the B operand pair b (two n8-tiles).
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  tc::mma(d0, a, b[0], b[1]);
  tc::mma(d1, a, b[2], b[3]);
}

// Rows g and g + 8 of sum_k A[r][k] * D[r][k], where A's fragments and the
// accumulators D hold the same elements (the fragment layouts' identity):
// this lane's part; the quad's four lanes add up to the whole rows.
template <int KS>
__device__ __forceinline__ void frag_dot(const uint32_t (&a)[KS][4],
                                         const float (&d)[2 * KS][4],
                                         int nks, float& ra, float& rb) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= nks) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {    // a0: d[2ks] row g; a1: row g + 8;
      const float2 f = __bfloat1622float2(   // a2, a3: d[2ks + 1]
          *reinterpret_cast<const __nv_bfloat162*>(&a[ks][r]));
      const float(&t)[4] = d[2 * ks + (r >> 1)];
      if (r & 1)
        rb += f.x * t[2] + f.y * t[3];
      else
        ra += f.x * t[0] + f.y * t[1];
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// An accumulator pair (two n8-tiles of one 16-row block) as the A
// fragments of the next product, high and low parts.
__device__ __forceinline__ void acc_to_a(const float (&t0)[4],
                                         const float (&t1)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  tc::split_bf16(t0[0], t0[1], hi[0], lo[0]);
  tc::split_bf16(t0[2], t0[3], hi[1], lo[1]);
  tc::split_bf16(t1[0], t1[1], hi[2], lo[2]);
  tc::split_bf16(t1[2], t1[3], hi[3], lo[3]);
}

// Chunk pass for bf16: one block of 8 warps per (batch, chunk, head), the
// scalar chunk pass's sums on the tensor cores (mma.sync m16n8k16, f32
// accumulators).  No [Q][Q] tile is kept: the triangle is recomputed in
// each orientation instead, 16 x 16 at a time in registers.
//   rows i (warp w: row blocks w, w + 8, ...):
//     E = exp(cum_i) (dy S_prev);  d cum_i += C_i . E_i
//     G = C B^T, D = dy x^T;       d cum_i += sum_j D G L dt_j
//     dC_h = E + dG B,             dG = D L dt_j  (j <= i)
//   rows j (the same warps, column blocks j):
//     dx = w (B dS^T) + scores^T dy,  scores^T = (B C^T) L^T dt_j
//     dB_h = w (x dS) + dG^T C,       dG^T = (x dy^T) L^T dt_j  (i >= j)
//     dw_j = B_j . (x dS)_j;  ddt_j's direct term sum_i D G L
// A warp's row block i has i + 1 column blocks and its row block j has
// Q/16 - j, so at Q = 128 every warp does the same work.  The f32
// operands of a product (dG, scores, S_prev, dS) go in as a high plus a
// low bf16 part, as in the forward.  d cum becomes ddt and dA as in the
// scalar pass.
template <int NTN>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_bwd_chunk_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                 const float* __restrict__ states,
                 const float* __restrict__ dS_all, bf16* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dB_h,
                 float* __restrict__ dC_h, float* __restrict__ dA_part, int S,
                 int H, int P, int N, int Q, long long xsb, long long xst,
                 long long bsb, long long bst, long long csb, long long cst,
                 int vec) {
  constexpr int KS = NTN / 2;          // k-steps over N allocated
  constexpr int PK = kBwdMaxP / 16;    // k-steps over P allocated
  extern __shared__ __align__(128) unsigned char ssd_smem[];
  const BwdLayout L = bwd_layout(Q, P, N);
  bf16* sx = reinterpret_cast<bf16*>(ssd_smem + L.x);
  bf16* sg = reinterpret_cast<bf16*>(ssd_smem + L.g);
  bf16* sb = reinterpret_cast<bf16*>(ssd_smem + L.b);
  bf16* sc = reinterpret_cast<bf16*>(ssd_smem + L.c);
  bf16* s_hi = reinterpret_cast<bf16*>(ssd_smem + L.s_hi);
  bf16* s_lo = reinterpret_cast<bf16*>(ssd_smem + L.s_lo);
  bf16* d_hi = reinterpret_cast<bf16*>(ssd_smem + L.d_hi);
  bf16* d_lo = reinterpret_cast<bf16*>(ssd_smem + L.d_lo);
  float* sdt = reinterpret_cast<float*>(ssd_smem + L.rows);
  float* scum = sdt + L.Qp;
  float* se = scum + L.Qp;           // exp(cum_i)
  float* sw = se + L.Qp;             // exp(cum_last - cum_j) dt_j
  float* rowd = sw + L.Qp;           // d cum_i through rows i
  float* direct = rowd + L.Qp;       // d dt_j through scores' dt_j
  float* sdw = direct + L.Qp;        // d w_j
  float* dda = sdw + L.Qp;           // d (dt a)_j
  float* red = dda + L.Qp;           // [kBwdWarps]

  const int n_chunks = (S + Q - 1) / Q;
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  const int c = bc % n_chunks, b = bc / n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const float a = A[h];
  const int nks = L.Np / 16, npk = L.Pp / 16, nrb = L.Qp / 16;
  const long long row = (long long)H * P;
  const size_t so = chunk_state_off(b, c, h, n_chunks, H, P, N);
  const float* sp = states + so;     // S_prev [P][N]
  const float* dsp = dS_all + so;    // dS [P][N]

  zero_cols<kBwdThreads>(sx, L.Qp, P, L.Pp, L.xp, L.xs);
  zero_cols<kBwdThreads>(sg, L.Qp, P, L.Pp, L.xp, L.xs);
  zero_cols<kBwdThreads>(sb, L.Qp, N, L.Np, L.np, L.ns);
  zero_cols<kBwdThreads>(sc, L.Qp, N, L.Np, L.np, L.ns);
  load_rows<kBwdThreads>(sx, L.xp, L.xs, x + b * xsb + (size_t)h * P, xst,
                         t0, rows, L.Qp, P, vec);
  load_rows<kBwdThreads>(sg, L.xp, L.xs,
                         dy + (size_t)b * S * row + (size_t)h * P, row, t0,
                         rows, L.Qp, P, vec);
  load_rows<kBwdThreads>(sb, L.np, L.ns, Bm + b * bsb, bst, t0, rows, L.Qp,
                         N, vec);
  load_rows<kBwdThreads>(sc, L.np, L.ns, Cm + b * csb, cst, t0, rows, L.Qp,
                         N, vec);
  load_dt<kBwdThreads>(sdt, dt + (size_t)b * S * H + h, H, t0, rows, L.Qp,
                       vec);
  tc::cp_async_commit();
  // S_prev and dS as high and low parts, zero past P and N
  const int hn = L.Np / 2;
  for (int i = tid; i < L.Pp * hn; i += kBwdThreads) {
    const int p = i / hn, n = (i - p * hn) * 2;
    float s0 = 0.f, s1 = 0.f, g0 = 0.f, g1 = 0.f;
    if (p < P && n < N) {
      s0 = sp[(size_t)p * N + n];
      g0 = dsp[(size_t)p * N + n];
      if (n + 1 < N) {
        s1 = sp[(size_t)p * N + n + 1];
        g1 = dsp[(size_t)p * N + n + 1];
      }
    }
    const int o = tc::tile_off(p, n, L.np, L.ns);
    tc::split_bf16(s0, s1, *reinterpret_cast<uint32_t*>(s_hi + o),
                   *reinterpret_cast<uint32_t*>(s_lo + o));
    tc::split_bf16(g0, g1, *reinterpret_cast<uint32_t*>(d_hi + o),
                   *reinterpret_cast<uint32_t*>(d_lo + o));
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum<kBwdWarps>(sdt, a, scum, red, L.Qp);
  const float cum_last = scum[L.Qp - 1];     // padded rows add dt = 0
  for (int j = tid; j < L.Qp; j += kBwdThreads) {
    se[j] = expf(scum[j]);
    sw[j] = expf(cum_last - scum[j]) * sdt[j];
  }
  __syncthreads();

  // ---- rows i: dC_h and d cum_i ----
  for (int rb = warp; rb < nrb; rb += kBwdWarps) {
    const int i0 = rb * 16;
    if (i0 >= rows) continue;
    uint32_t cf[KS][4], yf[PK][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks < nks) a_frag(cf[ks], sc, i0, ks, L.np, L.ns, lane);
#pragma unroll
    for (int pk = 0; pk < PK; ++pk)
      if (pk < npk) a_frag(yf[pk], sg, i0, pk, L.xp, L.xs, lane);
    float acc[NTN][4];
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    // E = exp(cum_i) (dy S_prev): S_prev [p][n] is k-major here
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      if (q >= nks) continue;
#pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk >= npk) continue;
        uint32_t hi[4], lo[4];
        b_kn(hi, s_hi, pk * 16, q * 16, L.np, L.ns, lane);
        b_kn(lo, s_lo, pk * 16, q * 16, L.np, L.ns, lane);
        mma2(acc[2 * q], acc[2 * q + 1], yf[pk], hi);
        mma2(acc[2 * q], acc[2 * q + 1], yf[pk], lo);
      }
    }
    const int ia = i0 + (lane >> 2), ib = ia + 8;
    const float ca = scum[ia], cb = scum[ib];
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      acc[nt][0] *= se[ia];
      acc[nt][1] *= se[ia];
      acc[nt][2] *= se[ib];
      acc[nt][3] *= se[ib];
    }
    float ra = 0.f, rbs = 0.f;       // d cum of rows ia and ib
    frag_dot<KS>(cf, acc, nks, ra, rbs);
    // the triangle, 16 columns j at a time
    for (int jk = 0; jk <= rb; ++jk) {
      float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nks) continue;
        uint32_t bk[4];
        b_nk(bk, sb, jk * 16, ks, L.np, L.ns, lane);
        mma2(gt[0], gt[1], cf[ks], bk);
      }
#pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk >= npk) continue;
        uint32_t xk[4];
        b_nk(xk, sx, jk * 16, pk, L.xp, L.xs, lane);
        mma2(dd[0], dd[1], yf[pk], xk);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jk * 16 + nt * 8 + (lane & 3) * 2 + (e & 1);
          const int i = e < 2 ? ia : ib;
          float dg = 0.f;
          if (j <= i) {
            const float l = expf((e < 2 ? ca : cb) - scum[j]) * sdt[j];
            const float t = dd[nt][e] * gt[nt][e] * l;
            if (e < 2)
              ra += t;
            else
              rbs += t;
            dg = dd[nt][e] * l;
          }
          dd[nt][e] = dg;
        }
      }
      uint32_t gh[4], gl[4];
      acc_to_a(dd[0], dd[1], gh, gl);
      // dC_h += dG B_j: B [j][n] is k-major here
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        if (q >= nks) continue;
        uint32_t bx[4];
        b_kn(bx, sb, jk * 16, q * 16, L.np, L.ns, lane);
        mma2(acc[2 * q], acc[2 * q + 1], gh, bx);
        mma2(acc[2 * q], acc[2 * q + 1], gl, bx);
      }
    }
    ra = quad_sum(ra);
    rbs = quad_sum(rbs);
    if ((lane & 3) == 0) {
      rowd[ia] = ra;
      rowd[ib] = rbs;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? ib : ia;
      if (i >= rows) continue;
      float* dst = dC_h + (((size_t)b * S + t0 + i) * H + h) * N;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const int n = nt * 8 + (lane & 3) * 2;
        if (n < N) dst[n] = acc[nt][2 * half];
        if (n + 1 < N) dst[n + 1] = acc[nt][2 * half + 1];
      }
    }
  }

  // ---- rows j: dx, dB_h, dw_j and ddt_j's direct term ----
  for (int jb = warp; jb < nrb; jb += kBwdWarps) {
    const int j0 = jb * 16;
    if (j0 >= rows) continue;
    uint32_t bf[KS][4], xf[PK][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks < nks) a_frag(bf[ks], sb, j0, ks, L.np, L.ns, lane);
#pragma unroll
    for (int pk = 0; pk < PK; ++pk)
      if (pk < npk) a_frag(xf[pk], sx, j0, pk, L.xp, L.xs, lane);
    float ax[2 * PK][4], ab[NTN][4];
#pragma unroll
    for (int t = 0; t < 2 * PK; ++t)
      ax[t][0] = ax[t][1] = ax[t][2] = ax[t][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
      ab[nt][0] = ab[nt][1] = ab[nt][2] = ab[nt][3] = 0.f;
    // B dS^T (dS [p][n] as [n][k]) and x dS (dS [p][n] k-major)
#pragma unroll
    for (int q = 0; q < PK; ++q) {
      if (q >= npk) continue;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nks) continue;
        uint32_t hi[4], lo[4];
        b_nk(hi, d_hi, q * 16, ks, L.np, L.ns, lane);
        b_nk(lo, d_lo, q * 16, ks, L.np, L.ns, lane);
        mma2(ax[2 * q], ax[2 * q + 1], bf[ks], hi);
        mma2(ax[2 * q], ax[2 * q + 1], bf[ks], lo);
      }
    }
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      if (q >= nks) continue;
#pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk >= npk) continue;
        uint32_t hi[4], lo[4];
        b_kn(hi, d_hi, pk * 16, q * 16, L.np, L.ns, lane);
        b_kn(lo, d_lo, pk * 16, q * 16, L.np, L.ns, lane);
        mma2(ab[2 * q], ab[2 * q + 1], xf[pk], hi);
        mma2(ab[2 * q], ab[2 * q + 1], xf[pk], lo);
      }
    }
    const int ja = j0 + (lane >> 2), jb2 = ja + 8;
    float wa = 0.f, wb = 0.f;        // dw of rows ja and jb2
    frag_dot<KS>(bf, ab, nks, wa, wb);
    const float swa = sw[ja], swb = sw[jb2];
#pragma unroll
    for (int t = 0; t < 2 * PK; ++t) {
      ax[t][0] *= swa;
      ax[t][1] *= swa;
      ax[t][2] *= swb;
      ax[t][3] *= swb;
    }
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      ab[nt][0] *= swa;
      ab[nt][1] *= swa;
      ab[nt][2] *= swb;
      ab[nt][3] *= swb;
    }
    const float ca = scum[ja], cb = scum[jb2];
    const float da = sdt[ja], db = sdt[jb2];
    float ua = 0.f, ub = 0.f;        // ddt's direct term of ja and jb2
    for (int ik = jb; ik < nrb && ik * 16 < rows; ++ik) {
      float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nks) continue;
        uint32_t ck[4];
        b_nk(ck, sc, ik * 16, ks, L.np, L.ns, lane);
        mma2(gt[0], gt[1], bf[ks], ck);
      }
#pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk >= npk) continue;
        uint32_t yk[4];
        b_nk(yk, sg, ik * 16, pk, L.xp, L.xs, lane);
        mma2(dd[0], dd[1], xf[pk], yk);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ik * 16 + nt * 8 + (lane & 3) * 2 + (e & 1);
          const int j = e < 2 ? ja : jb2;
          float sc_ = 0.f, dg = 0.f;
          if (i >= j) {
            const float l = expf(scum[i] - (e < 2 ? ca : cb));
            const float dtj = e < 2 ? da : db;
            const float u = dd[nt][e] * gt[nt][e] * l;
            if (e < 2)
              ua += u;
            else
              ub += u;
            sc_ = gt[nt][e] * l * dtj;
            dg = dd[nt][e] * l * dtj;
          }
          gt[nt][e] = sc_;
          dd[nt][e] = dg;
        }
      }
      uint32_t th[4], tl[4], gh[4], gl[4];
      acc_to_a(gt[0], gt[1], th, tl);
      acc_to_a(dd[0], dd[1], gh, gl);
      // dx += scores^T dy_i, dB_h += dG^T C_i (dy and C k-major here)
#pragma unroll
      for (int q = 0; q < PK; ++q) {
        if (q >= npk) continue;
        uint32_t bx[4];
        b_kn(bx, sg, ik * 16, q * 16, L.xp, L.xs, lane);
        mma2(ax[2 * q], ax[2 * q + 1], th, bx);
        mma2(ax[2 * q], ax[2 * q + 1], tl, bx);
      }
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        if (q >= nks) continue;
        uint32_t bx[4];
        b_kn(bx, sc, ik * 16, q * 16, L.np, L.ns, lane);
        mma2(ab[2 * q], ab[2 * q + 1], gh, bx);
        mma2(ab[2 * q], ab[2 * q + 1], gl, bx);
      }
    }
    ua = quad_sum(ua);
    ub = quad_sum(ub);
    wa = quad_sum(wa);
    wb = quad_sum(wb);
    if ((lane & 3) == 0) {
      direct[ja] = ua;
      direct[jb2] = ub;
      sdw[ja] = wa;
      sdw[jb2] = wb;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = half ? jb2 : ja;
      if (j >= rows) continue;
      bf16* xr = dx + ((size_t)b * S + t0 + j) * row + (size_t)h * P;
#pragma unroll
      for (int t = 0; t < 2 * PK; ++t) {
        const int p = t * 8 + (lane & 3) * 2;
        const float v0 = ax[t][2 * half], v1 = ax[t][2 * half + 1];
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<uint32_t*>(xr + p) = tc::pack_bf16(v0, v1);
        } else {
          if (p < P) xr[p] = __float2bfloat16(v0);
          if (p + 1 < P) xr[p + 1] = __float2bfloat16(v1);
        }
      }
      float* br = dB_h + (((size_t)b * S + t0 + j) * H + h) * N;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const int n = nt * 8 + (lane & 3) * 2;
        if (n < N) br[n] = ab[nt][2 * half];
        if (n + 1 < N) br[n + 1] = ab[nt][2 * half + 1];
      }
    }
  }

  // dS . S_prev in f32 from device memory, for the decay exp(cum_last)
  float v = 0.f;
  for (int i = tid; i < P * N; i += kBwdThreads) v = fmaf(dsp[i], sp[i], v);
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float sdot = 0.f, wsum = 0.f;
    for (int k = 0; k < kBwdWarps; ++k) sdot += red[k];
    for (int j = 0; j < rows; ++j) wsum = fmaf(sdw[j], sw[j], wsum);
    float run = expf(cum_last) * sdot + wsum;    // d cum_last's extra
    float da = 0.f;
    for (int j = L.Qp - 1; j >= 0; --j) {
      if (j < rows) run += rowd[j] - direct[j] * sdt[j] - sdw[j] * sw[j];
      dda[j] = run;
      da = fmaf(sdt[j], run, da);
    }
    dA_part[((size_t)b * n_chunks + c) * H + h] = da;
  }
  __syncthreads();
  for (int j = tid; j < rows; j += kBwdThreads)
    ddt[((size_t)b * S + t0 + j) * H + h] =
        a * dda[j] + direct[j] + sdw[j] * expf(cum_last - scum[j]);
}

template <int NTN>
int launch_bwd_tc(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* dy,
                  const void* dfinal, const void* states, void* dS_all,
                  void* dB_h, void* dC_h, void* dA_part, void* dx, void* ddt,
                  void* dA, void* dB, void* dC, void* dinit, int B, int S,
                  int H, int P, int N, int Q, long long xsb, long long xst,
                  long long bsb, long long bst, long long csb, long long cst,
                  cudaStream_t stream) {
  const TcLayout Lc = tc_layout(Q, P, N);
  const BwdLayout Lb = bwd_layout(Q, P, N);
  if (P > kBwdMaxP || Lc.total > kSmemLimit || Lb.total > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_carry_tc<NTN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Lc.total);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_tc<NTN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Lb.total);
  if (err != cudaSuccess) return (int)err;
  const long long row = (long long)H * P;
  const int vec = P % 8 == 0 && N % 8 == 0 &&
                  (xsb | xst | bsb | bst | csb | cst | row) % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm |
                   (uintptr_t)dy) % 16 == 0;
  const int n_chunks = (S + Q - 1) / Q;
  ssd_bwd_carry_tc<NTN><<<B * H * ((P + kSliceP - 1) / kSliceP),
                          kTcThreads, Lc.total, stream>>>(
      (const bf16*)dy, (const float*)dt, (const float*)A, (const bf16*)Cm,
      (const float*)dfinal, (float*)dS_all, (float*)dinit, S, H, P, N, Q, csb,
      cst, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_tc<NTN><<<B * n_chunks * H, kBwdThreads, Lb.total, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const float*)states,
      (const float*)dS_all, (bf16*)dx, (float*)ddt, (float*)dB_h,
      (float*)dC_h, (float*)dA_part, S, H, P, N, Q, xsb, xst, bsb, bst, csb,
      cst, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long BS = (long long)B * S;
  ssd_bwd_reduce<bf16><<<(unsigned)((BS * N + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      (const float*)dB_h, (const float*)dC_h, (const float*)dA_part,
      (bf16*)dB, (bf16*)dC, (float*)dA, BS, H, N, B * n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel,
// N <= 128) for x, B, C and y; dt, A, init_state and final_state are f32.
// x [B, S, H, P] with batch stride xsb and token stride xst (elements; the
// head and P strides are P and 1); B and C [B, S, N] with strides
// (bsb, bst, 1) and (csb, cst, 1); dt [B, S, H], A [H], y [B, S, H, P],
// init_state (or null for zeros) and final_state [B, H, P, N] contiguous.
// states, unless null, receives the state each chunk starts from,
// [B, C, H, P, N] in f32 (C = ceil(S / Q)), for the backward.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* final_state,
                               void* states, int dtype, int B, int S, int H,
                               int P, int N, int Q, long long xsb,
                               long long xst, long long bsb, long long bst,
                               long long csb, long long cst, void* stream) {
  if (dtype == 0)
    return launch_f32(x, dt, A, Bm, Cm, init, y, final_state, states, B, S,
                      H, P, N, Q, xsb, xst, bsb, bst, csb, cst, stream);
  if (N <= 64)
    return launch_tc<8>(x, dt, A, Bm, Cm, init, y, final_state, states, B,
                        S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst, stream);
  if (N <= 128)
    return launch_tc<16>(x, dt, A, Bm, Cm, init, y, final_state, states, B,
                         S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst,
                         stream);
  return (int)cudaErrorInvalidValue;
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
// allocates: dS_all [B, C, H, P, N], dB_h and dC_h [B, S, H, N], dA_part
// [B, C, H], all f32.  Writes dx [B, S, H, P], ddt [B, S, H], dA [H], dB
// and dC [B, S, N] and, unless null, dinit [B, H, P, N].  Three launches on
// `stream`: the carry pass, the chunk pass, the reduction over heads.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* states,
    void* dS_all, void* dB_h, void* dC_h, void* dA_part, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, int dtype, int B, int S,
    int H, int P, int N, int Q, long long xsb, long long xst, long long bsb,
    long long bst, long long csb, long long cst, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_f32(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                          dB_h, dC_h, dA_part, dx, ddt, dA, dB, dC, dinit, B,
                          S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst, st);
  if (N <= 64)
    return launch_bwd_tc<8>(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                            dB_h, dC_h, dA_part, dx, ddt, dA, dB, dC, dinit,
                            B, S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst,
                            st);
  if (N <= 128)
    return launch_bwd_tc<16>(x, dt, A, Bm, Cm, dy, dfinal, states, dS_all,
                             dB_h, dC_h, dA_part, dx, ddt, dA, dB, dC, dinit,
                             B, S, H, P, N, Q, xsb, xst, bsb, bst, csb, cst,
                             st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block of the backward's carry pass (pass 0;
// f32: a slice of ssd_scan_bwd_carry_slice columns) and of its chunk pass
// (pass 1), for dtype 0 = f32 (the scalar kernels) or 1 = bf16.
extern "C" long long ssd_scan_bwd_smem_bytes(int Q, int P, int N, int dtype,
                                             int pass) {
  if (dtype == 1)
    return (long long)(pass == 0 ? tc_layout(Q, P, N).total
                                 : bwd_layout(Q, P, N).total);
  return (long long)(pass == 0 ? carry_smem_bytes(Q, carry_slice(Q, P, N), N)
                               : chunk_smem_bytes(Q));
}

// Columns of P a block of the carry pass owns (0: the chunk does not fit).
extern "C" int ssd_scan_bwd_carry_slice(int Q, int P, int N) {
  return carry_slice(Q, P, N);
}
