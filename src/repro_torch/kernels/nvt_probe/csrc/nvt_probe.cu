// nvt_probe for Hopper (sm_90a): the batched read-only hash probe over
// dense bucket tiles -- the journey of the NVTraverse map, which does no
// persistence work.
//
// Replaces the Pallas TPU kernel src/repro/kernels/nvt_probe/kernel.py
// (`_kernel`, launched by `nvt_probe_kernel`).  That kernel streams every
// bucket tile past every query block on a (Q/block_q, NB/block_nb) grid,
// i.e. O(Q * NB * cap) compares to use one row per query.  Here each query
// reads exactly its own row.
//
// Bound on this card: bytes, the figure chip_smoke.py reports as
// `bound_ms`.  The probe must read each distinct row its queries touch
// (`cap * 4` bytes), each 4-byte query and the values of the hit slots
// once, and write two 4-byte results per query; it does a handful of
// integer operations per byte, so it can at best run at the HBM rate
// (3.35 TB/s).  For 2^20 uniform queries over 2^20 rows of 32 that is
// about 96.5 MB, 28.8 us.  The rows are scattered at random, so the card
// needs many independent rows in flight (Little's law: 3.35 TB/s times a
// loaded latency near 0.7 us is 2-3 MB across the card), and then its
// rate of random sector reads limits it: on an H100 this kernel stays
// near 2.2x the byte bound, 0.048 ms of its time reading the rows and
// the rest reading the hit values, a cost that overlapping them with the
// next batch's rows did not hide (tools/kernel_variants.py, PERF.md).
//
// Design ("batch32"): a persistent grid of warps, each taking batches of
// 32 queries; lane r of a warp answers the batch's query r.
//
//   * one coalesced load brings a batch's 32 queries, one per lane, and
//     the next batch's are loaded while this batch's rows are read; each
//     lane hashes its own (the query round trip is paid once per 32);
//   * a row is read by a group of `L` lanes as vectors of `VEC` int32
//     (VEC = 4, 16-byte loads, when the key rows are 16-byte aligned; else
//     VEC = 1), so one load instruction reads 32 / L rows (4 rows of 128
//     bytes for cap = 32); rows wider than L * VEC <= 32 words take
//     `chunks` passes;
//   * every row of a wave (all 32 rows of the batch for cap = 32) is
//     loaded into registers before any is compared: 32 lines in flight
//     per warp where a warp a query had one;
//   * lane r gathers its row's hit bits from the L lanes that read it
//     (L shuffles) and loads the values of its hit slots itself, so the
//     value loads of all 32 queries go out together, 4 bytes a hit and
//     one register a lane; `found` is "any hit", the sum wraps in
//     `unsigned` like the reference's int32 sum, and each batch ends in
//     one coalesced store per output;
//   * caps that are not a multiple of 4, unaligned tiles and a ragged
//     last batch take the same code with VEC = 1 and guarded slots and
//     rows.
//
// The launch geometry (VEC, L, chunks) is computed by the Python binding
// (kernel.py:launch_geometry, tested on the host) and checked here.
//
// Reference quirks kept on purpose: key 0 marks an empty slot, so a query
// of 0 "finds" each empty slot of its row and sums their values as
// stored; NB need not be a power of two (the modulus is unsigned 32-bit);
// duplicate keys in a row sum their values; -1 is an ordinary query.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernel
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// Tuned on an H100 against the alternatives that
// tools/kernel_variants.py --only nvt_probe times (PERF.md): row
// loads with cache hints, a multiply-high modulus, no query prefetch,
// fewer rows in flight, 4 or 16 warps a block, one batch a warp, rows
// read as single words.
//
// int32 words of row a lane holds in flight per wave (32: all 32 rows of
// a cap-32 batch at once);
constexpr int kWaveWords = 32;
// blocks an SM must hold with 16-byte row loads (caps the registers a
// thread may use: 80 at 3, where the cap-32 kernel needs no spill; the
// single-word instantiations would spill, and keep no minimum).
constexpr int kMinBlocks = 3;

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int load_query(const int* queries, int batch,
                                          int lane, int n_queries) {
  const long long i = ((long long)batch << 5) + lane;
  return i < n_queries ? __ldg(queries + i) : 0;
}

template <int VEC> struct Words;
template <> struct Words<4> {
  using T = int4;
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  // bit e set where word e equals q
  static __device__ __forceinline__ unsigned match(T v, int q) {
    return (v.x == q) | (v.y == q) << 1 | (v.z == q) << 2 | (v.w == q) << 3;
  }
};
template <> struct Words<1> {
  using T = int;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ unsigned match(T v, int q) {
    return v == q;
  }
};

// The sum of row[i] over the set bits i of m, wrapping like int32.  Two
// hits' loads are issued together a round; a row with more hits (a
// duplicated key, or query 0 over several empty slots) takes more rounds.
__device__ __forceinline__ unsigned hit_values(const int* row, unsigned m) {
  unsigned sum = 0;
  while (m) {
    const int i0 = __ffs(m) - 1;
    m &= m - 1;
    const unsigned m1 = m;
    const int i1 = __ffs(m1) - 1;
    m &= m - 1;
    sum += (unsigned)__ldg(row + i0) + (m1 ? (unsigned)__ldg(row + i1)
                                           : 0u);
  }
  return sum;
}

// VEC: int32 words per lane load (4 or 1); L: lanes per row (a power of
// two, L * VEC <= 32).  Each batch is L steps; step s covers rows
// s*R .. s*R+R-1 of the batch, row s*R+g read by the lanes g*L .. g*L+L-1
// of group g, in `chunks` passes of L * VEC slots.
template <int VEC, int L>
__global__ void __launch_bounds__(kThreads, VEC == 4 ? kMinBlocks : 1)
nvt_probe_batch(const int* __restrict__ keys, const int* __restrict__ vals,
                const int* __restrict__ queries, int* __restrict__ found,
                int* __restrict__ out, unsigned n_buckets, int cap,
                int chunks, int n_queries) {
  using W = Words<VEC>;
  using T = typename W::T;
  constexpr int R = 32 / L;                // rows a load instruction reads
  // steps a wave: as many as kWaveWords words of row per lane allow
  constexpr int S = kWaveWords / VEC < L ? kWaveWords / VEC : L;
  constexpr unsigned kVecMask = (1u << VEC) - 1;
  static_assert(32 % L == 0 && L % S == 0 && S * VEC <= 32 && L * VEC <= 32,
                "geometry");

  const int lane = threadIdx.x & 31;
  const int grp = lane / L;               // row of a step this lane reads
  const int sub = lane % L;               // its vector of that row
  // lane r answers row r of the batch: step r / R, group r % R
  const int my_step = lane / R, my_grp = lane % R;
  const int nvec = cap / VEC;
  const T* kt = reinterpret_cast<const T*>(keys);
  const int batches = (int)(((long long)n_queries + 31) >> 5);
  const int stride = gridDim.x * kWarps;
  int batch = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int q_next = load_query(queries, batch, lane, n_queries);
  for (; batch < batches; batch += stride) {
    const int base = batch << 5;
    const int n = min(32, n_queries - base);          // rows of the batch
    const int q = q_next;                 // the next batch's in flight
    q_next = load_query(queries, batch + stride, lane, n_queries);
    const unsigned b = mix32((unsigned)q) % n_buckets;
    const int* my_vals = vals + (size_t)b * cap;      // row `lane`'s values
    unsigned any = 0, sum = 0;                        // and its answer
#pragma unroll
    for (int w = 0; w < L; w += S) {
      unsigned br[S];                     // bucket of each step's row
#pragma unroll
      for (int i = 0; i < S; ++i)
        br[i] = __shfl_sync(kFull, b, (w + i) * R + grp);
      for (int c = 0; c < chunks; ++c) {
        const int v = c * L + sub;        // this lane's vector of the row
        // 1. every key vector of the wave in flight before any compare
        T kv[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const bool ok = (w + i) * R + grp < n && v < nvec;
          kv[i] = ok ? W::load(kt + (size_t)br[i] * nvec + v) : W::zero();
        }
        unsigned hits = 0;                // VEC bits per step
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int r = (w + i) * R + grp;
          const int qr = __shfl_sync(kFull, q, r);
          hits |= (r < n && v < nvec ? W::match(kv[i], qr) : 0u)
                  << (i * VEC);
        }
        // 2. lane r gathers its row's hits in this pass from the L lanes
        // that read it (bit t*VEC+e: word e of lane t's vector) ...
        unsigned mine = 0;
        const int at = (my_step - w) * VEC;
#pragma unroll
        for (int t = 0; t < L; ++t) {
          const unsigned h = __shfl_sync(kFull, hits, my_grp * L + t);
          mine |= ((h >> (at & 31)) & kVecMask) << (t * VEC);
        }
        if (my_step < w || my_step >= w + S) mine = 0;
        // 3. ... and loads the values of those slots itself: every lane's
        // value loads go out together, 4 bytes a hit
        any |= mine;
        sum += hit_values(my_vals + c * L * VEC, mine);
      }
    }
    if (lane < n) {
      found[base + lane] = any != 0u;
      out[base + lane] = (int)sum;
    }
  }
}

template <int VEC, int L>
int launch(const void* keys, const void* vals, const void* queries,
           void* found, void* out, unsigned n_buckets, int cap, int chunks,
           int n_queries, cudaStream_t stream) {
  // a persistent grid: as many blocks as fit on the card at once, or
  // fewer when the batches run out first
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, nvt_probe_batch<VEC, L>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long batches = ((long long)n_queries + 31) / 32;
  const long long need = (batches + kWarps - 1) / kWarps;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(need < most ? need : most);
  nvt_probe_batch<VEC, L><<<grid, kThreads, 0, stream>>>(
      (const int*)keys, (const int*)vals, (const int*)queries, (int*)found,
      (int*)out, n_buckets, cap, chunks, n_queries);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_lanes(int lanes, const void* keys, const void* vals,
                 const void* queries, void* found, void* out,
                 unsigned n_buckets, int cap, int chunks, int n_queries,
                 cudaStream_t stream) {
#define NVT_PROBE_LANES(L)                                                  \
  case L:                                                                   \
    return launch<VEC, L>(keys, vals, queries, found, out, n_buckets, cap, \
                          chunks, n_queries, stream);
  switch (lanes) {
    NVT_PROBE_LANES(1)
    NVT_PROBE_LANES(2)
    NVT_PROBE_LANES(4)
    NVT_PROBE_LANES(8)
  }
  if constexpr (VEC == 1) {
    switch (lanes) {
      NVT_PROBE_LANES(16)
      NVT_PROBE_LANES(32)
    }
  }
#undef NVT_PROBE_LANES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vec, lanes and chunks are kernel.py:launch_geometry(cap, aligned);
// anything else is refused with cudaErrorInvalidValue before a launch.
extern "C" int nvt_probe_launch(const void* keys, const void* vals,
                                const void* queries, void* found, void* out,
                                int n_buckets, int cap, int vec, int lanes,
                                int chunks, int n_queries, void* stream) {
  if (n_buckets < 1 || cap < 1 || n_queries < 1 || (vec != 1 && vec != 4) ||
      lanes < 1 || lanes * vec > 32 || cap % vec ||
      chunks != (cap / vec + lanes - 1) / lanes)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && ((uintptr_t)keys & 15))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? launch_lanes<4>(lanes, keys, vals, queries, found, out,
                                    (unsigned)n_buckets, cap, chunks,
                                    n_queries, st)
                  : launch_lanes<1>(lanes, keys, vals, queries, found, out,
                                    (unsigned)n_buckets, cap, chunks,
                                    n_queries, st);
}
