// KV-checkpoint page gather for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/kv_checkpoint.py::checkpoint_gather (Pallas
// body _gather_kernel), the pack step of ConServe's incremental
// checkpointing and of blocking swap-out.
//
// What it computes: for a period-stacked pool leaf (P, N, page, Hkv, D) and
// an id list (K,), out[p, i] = pool[p, ids[i]] -- the chosen pages packed
// into a dense (P, K, page, Hkv, D) staging buffer, so that the copy to host
// memory is one contiguous transfer.  Ids may repeat (the engine pads id
// lists with the scratch block).  An id outside [0, N) writes zeros.
//
// What bounds it on this card: it does no arithmetic; it reads K pages and
// writes K pages per period, so it is bound by those bytes over the HBM rate.
//
// What the design does about that: a grid over (chunk of a page, id,
// period); every thread moves 16-byte vectors with kVecsPerThread loads in
// flight, neighbouring threads on neighbouring addresses, so each warp
// reads and writes whole 512-byte runs of one page.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
    gather_pages(const uint4* __restrict__ pool, const int* __restrict__ ids,
                 uint4* __restrict__ out, int n, int k, long long page_vecs) {
  const int i = blockIdx.y;
  const int p = blockIdx.z;
  const int id = ids[i];
  const bool valid = id >= 0 && id < n;
  const uint4* src = pool + ((long long)p * n + (valid ? id : 0)) * page_vecs;
  uint4* dst = out + ((long long)p * k + i) * page_vecs;
  const long long chunk = (long long)kThreads * kVecsPerThread;
  const long long start = (long long)blockIdx.x * chunk + threadIdx.x;
  uint4 buf[kVecsPerThread];
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const long long e = start + (long long)j * kThreads;
    buf[j] = (valid && e < page_vecs) ? src[e] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const long long e = start + (long long)j * kThreads;
    if (e < page_vecs) dst[e] = buf[j];
  }
}

}  // namespace

// pool: (periods, n, page_bytes) as 16-byte vectors; out: (periods, k, ...).
// page_bytes must be a multiple of 16 and both pointers 16-byte aligned (the
// wrapper checks).  Returns cudaGetLastError() after the launch (0 on
// success).  Launches on `stream`, allocates nothing, never synchronises.
extern "C" int checkpoint_gather(const void* pool, const void* ids, void* out,
                                 int periods, int n, int k, long long page_bytes,
                                 void* stream) {
  if (page_bytes % 16 != 0 || k <= 0 || periods <= 0) return (int)cudaErrorInvalidValue;
  const long long page_vecs = page_bytes / 16;
  const long long chunk = (long long)kThreads * kVecsPerThread;
  dim3 grid((unsigned)((page_vecs + chunk - 1) / chunk), k, periods);
  gather_pages<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int*>(ids),
      static_cast<uint4*>(out), n, k, page_vecs);
  return (int)cudaGetLastError();
}
