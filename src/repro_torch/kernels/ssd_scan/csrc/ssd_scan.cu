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
               T* __restrict__ y, float* __restrict__ final_state, int S,
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
               int B, int S, int H, int P, int N, int Q, long long xsb,
               long long xst, long long bsb, long long bst, long long csb,
               long long cst, void* stream) {
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
      S, H, P, N, Q, PS, xsb, xst, bsb, bst, csb, cst);
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

__device__ __forceinline__ void zero_cols(bf16* t, int rows, int c0, int c1,
                                          int pitch, int swz) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < rows * w; i += kTcThreads) {
    const int r = i / w;
    t[tc::tile_off(r, c0 + i - r * w, pitch, swz)] = __float2bfloat16(0.f);
  }
}

// Columns [0, width) of tokens t0 .. t0 + Qp - 1 into a [Qp][pitch] bf16
// tile; rows from `rows` on (past the chunk or the sequence) are zero.
// vec: 16-byte cp.async (every row start 16-byte aligned, width % 8 ==
// 0), else plain loads.
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, int swz,
                                          const bf16* src, long long stride,
                                          int t0, int rows, int Qp,
                                          int width, bool vec) {
  if (vec) {
    const int chunks = width >> 3;
    for (int i = threadIdx.x; i < Qp * chunks; i += kTcThreads) {
      const int j = i / chunks, c = (i - j * chunks) << 3;
      const bool in = j < rows;
      tc::cp_async16(dst + tc::tile_off(j, c, pitch, swz),
                     in ? src + (t0 + j) * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * width; i += kTcThreads) {
      const int j = i / width, c = i - j * width;
      dst[tc::tile_off(j, c, pitch, swz)] =
          j < rows ? src[(t0 + j) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// dt of tokens t0 .. t0 + Qp - 1 (stride H), zero from `rows` on.
__device__ __forceinline__ void load_dt(float* dst, const float* src, int H,
                                        int t0, int rows, int Qp,
                                        bool vec) {
  for (int j = threadIdx.x; j < Qp; j += kTcThreads) {
    const bool in = j < rows;
    if (vec)
      tc::cp_async4(dst + j, in ? src + (size_t)(t0 + j) * H : src,
                    in ? 4 : 0);
    else
      dst[j] = in ? src[(size_t)(t0 + j) * H] : 0.f;
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
            bf16* __restrict__ y, float* __restrict__ final_state, int S,
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

    // cum = inclusive cumsum of dt * a: warp scans, then across warps
    float carry = 0.f;
    for (int base = 0; base < L.Qp; base += kTcThreads) {
      const int j = base + tid;
      float v = j < L.Qp ? sdt[j] * a : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) m.warp_sum[warp] = v;
      __syncthreads();
      float pre = carry;
      for (int w = 0; w < warp; ++w) pre += m.warp_sum[w];
      if (j < L.Qp) m.cum[j] = v + pre;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) carry += m.warp_sum[w];
      __syncthreads();
    }
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
              int B, int S, int H, int P, int N, int Q, long long xsb,
              long long xst, long long bsb, long long bst, long long csb,
              long long cst, void* stream) {
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
      (const bf16*)Cm, (const float*)init, (bf16*)y, (float*)final_state, S,
      H, P, N, Q, xsb, xst, bsb, bst, csb, cst, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel,
// N <= 128) for x, B, C and y; dt, A, init_state and final_state are f32.
// x [B, S, H, P] with batch stride xsb and token stride xst (elements; the
// head and P strides are P and 1); B and C [B, S, N] with strides
// (bsb, bst, 1) and (csb, cst, 1); dt [B, S, H], A [H], y [B, S, H, P],
// init_state (or null for zeros) and final_state [B, H, P, N] contiguous.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init, void* y, void* final_state,
                               int dtype, int B, int S, int H, int P, int N,
                               int Q, long long xsb, long long xst,
                               long long bsb, long long bst, long long csb,
                               long long cst, void* stream) {
  if (dtype == 0)
    return launch_f32(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, P, N,
                      Q, xsb, xst, bsb, bst, csb, cst, stream);
  if (N <= 64)
    return launch_tc<8>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, P,
                        N, Q, xsb, xst, bsb, bst, csb, cst, stream);
  if (N <= 128)
    return launch_tc<16>(x, dt, A, Bm, Cm, init, y, final_state, B, S, H, P,
                         N, Q, xsb, xst, bsb, bst, csb, cst, stream);
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
