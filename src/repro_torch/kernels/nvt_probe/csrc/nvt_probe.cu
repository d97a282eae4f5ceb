// nvt_probe for Hopper (sm_90a): the batched read-only hash probe over
// dense bucket tiles -- the journey of the NVTraverse map, which does no
// persistence work.
//
// Replaces the Pallas TPU kernel src/repro/kernels/nvt_probe/kernel.py
// (`_kernel`, launched by `nvt_probe_kernel`).  That kernel streams every
// bucket tile past every query block on a (Q/block_q, NB/block_nb) grid,
// i.e. O(Q * NB * cap) compares to use one row per query.  Here each query
// reads exactly its own row:
//
//   * one warp per query; the 32 lanes stride over the row's `cap` slots,
//     so with cap = 32 a row is one 128-byte line read by one coalesced
//     load;
//   * `__ballot_sync` gives `found`; `val` is a warp sum of the values
//     at the hit slots, read only on a hit and accumulated in `unsigned`
//     so that it wraps like the reference's int32 sum.
//
// Bound on this card: bytes, the figure chip_smoke.py reports as
// `bound_ms`.  The probe must read each distinct row its queries touch
// (`cap * 4` bytes), each 4-byte query and the values of the hit slots
// once, and write two 4-byte results per query; it does a handful of
// integer operations per byte, so it can at best run at the HBM rate
// (3.35 TB/s).  For 2^20 uniform queries over 2^20 rows of 32 that is
// about 96.5 MB (some 639k distinct rows), 28.8 us.  This kernel reads
// one row per query, repeats included (about 150 MB, 44 us at the same
// rate); a row read twice may come from L2.  Rows are scattered at
// random, so the design keeps each row read to one full line and keeps
// many independent rows in flight (8 warps per block, one row each);
// batching rows through shared memory with cp.async or TMA is later work.
//
// Reference quirks kept on purpose: key 0 marks an empty slot, so a
// query of 0 "finds" any bucket with an empty slot and returns 0;
// padded queries are -1; NB need not be a power of two (the modulus is
// unsigned 32-bit); duplicate keys in a row sum their values.
//
// Plain C interface, bound from Python with ctypes.  The caller owns
// every buffer (allocated with torch.empty) and the stream; the kernel
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;   // queries per block; Q is a multiple

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nvt_probe_warp(const int* __restrict__ keys, const int* __restrict__ vals,
               const int* __restrict__ queries, int* __restrict__ found,
               int* __restrict__ out, unsigned n_buckets, int cap) {
  const long long qi =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int q = __ldg(queries + qi);            // one broadcast load
  const size_t row = (size_t)(mix32((unsigned)q) % n_buckets) * cap;
  const int* rk = keys + row;
  const int* rv = vals + row;

  unsigned any = 0;
  unsigned sum = 0;
  for (int base = 0; base < cap; base += 32) {  // uniform trip count
    const int s = base + lane;
    const bool hit = s < cap && __ldg(rk + s) == q;
    if (hit) sum += (unsigned)__ldg(rv + s);
    any |= __ballot_sync(0xffffffffu, hit);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    found[qi] = any != 0u;
    out[qi] = (int)sum;
  }
}

}  // namespace

extern "C" int nvt_probe_launch(const void* keys, const void* vals,
                                const void* queries, void* found, void* out,
                                int n_buckets, int cap, int n_queries,
                                void* stream) {
  const dim3 grid(n_queries / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  nvt_probe_warp<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)vals, (const int*)queries, (int*)found,
      (int*)out, (unsigned)n_buckets, cap);
  return (int)cudaGetLastError();
}

extern "C" int nvt_probe_warps_per_block() { return kWarpsPerBlock; }
