// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (Pallas
// body _paged_kernel), the attention of every layer of a decode step on the
// split serving path (RealEngineConfig(fused_batch=False)).
//
// What it computes, per sequence b and query head h (one query token each):
//   score(t) = tanh((q . k_t) * D^-0.5 / cap) * cap   (cap = 0: no tanh)
//   keep(t)  = t < seq_len[b]  and  tables[b, t / page] >= 0
//   out      = softmax over kept t of score, applied to v_t
// with an fp32 online softmax.  Masked keys take no part at all (the plain
// version gives them -1e30, whose exp is exactly 0 next to a kept key), and
// a row that keeps no key (seq_len = 0) comes out exactly 0, as the Pallas
// kernel's safe divisor gives.  Only the pages below ceil(seq_len / page)
// are visited; a negative table entry is never dereferenced.  GQA is
// grouped KV-head-major: query head kvh * G + g reads KV head kvh.
//
// What bounds it on this card: it reads every K/V page up to each seq_len
// once per KV head, plus q, the table entries and seq_lens, and writes the
// output; it does 4 * D flops per (query head, key), about G / 2 flops per
// byte of K/V (bf16) -- far below the ~295 flops per byte where the H100's
// tensor cores would be the limit.  So its bound is those bytes over the
// HBM rate (3.35 TB/s).
//
// What the design does about that bound: one block per (KV head, sequence)
// holds that head's G query rows, so the G query heads of a group read each
// page once (the ragged kernel's 16-row tile would waste 15 of 16 rows at
// G = 1).  Pages stream through a ring of kStages shared-memory stages with
// 16-byte cp.async copies: all of a page's K and V copies are issued at
// once, kStages - 1 pages ahead of the page being computed, so several pages
// per block are in flight while the block computes.  Shared rows are padded
// by 16 bytes so the dot products of neighbouring keys hit other banks.
// Split-KV for long contexts with few (sequence, KV head) pairs, wgmma and
// TMA page loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;                               // pages in the ring
constexpr int kLanesPerKey = 8;                          // lanes of one dot product
constexpr int kKeysPerPass = kThreads / kLanesPerKey;    // 16
constexpr int kMaxOut = 8;                               // outputs per thread: G * D <= 1024
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A shared K or V row is D elements plus a 16-byte pad.
template <typename T, int D>
__host__ __device__ constexpr int row_elems() {
  return D + 16 / (int)sizeof(T);
}

// Shared memory: the ring [kStages][K, V][page][row], then in floats
// q [G][D], scores/probabilities [G][page], and per-row m, l, alpha.
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int g, int page) {
  return (size_t)kStages * 2 * page * row_elems<T, D>() * sizeof(T) +
         (size_t)(g * D + g * page + 3 * g) * sizeof(float);
}

// Keys of page pi that are kept: none if its table entry is negative.
__device__ __forceinline__ int kept_keys(int pi, int blk, int page, int seq_len) {
  return blk < 0 ? 0 : min(page, seq_len - pi * page);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ seq_lens, T* __restrict__ out, int h,
                  int hkv, int page, int m, float scale, float softcap) {
  constexpr int DP = row_elems<T, D>();
  constexpr int kVec = 16 / (int)sizeof(T);       // elements per 16-byte copy
  constexpr int kVecsPerRow = D / kVec;
  constexpr int kDimsPerLane = D / kLanesPerKey;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = h / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = tid % kLanesPerKey;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * page * DP);
  float* p_s = q_s + g * D;
  float* m_s = p_s + g * page;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  const int seq_len = seq_lens[b];
  const int npages = seq_len > 0 ? min(m, (seq_len + page - 1) / page) : 0;
  const int* table = tables + (size_t)b * m;
  const size_t tok_stride = (size_t)hkv * D;  // elements between a page's tokens

  // the G query rows of this KV head are contiguous: heads kvh*G .. kvh*G+G-1
  const T* qb = q + ((size_t)b * h + (size_t)kvh * g) * D;
  for (int e = tid; e < g * D; e += kThreads) q_s[e] = to_float(qb[e]);
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }

  // Issue every 16-byte copy of page pi's kept K and V rows into its stage,
  // then commit them as one group (an empty group past the last page).
  auto issue = [&](int pi) {
    if (pi < npages) {
      const int blk = table[pi];
      const int n = kept_keys(pi, blk, page, seq_len);
      T* st = ring + (size_t)(pi % kStages) * 2 * page * DP;
      const size_t base = (size_t)max(blk, 0) * page * tok_stride + (size_t)kvh * D;
      const int nvec = n * kVecsPerRow;
      for (int e = tid; e < 2 * nvec; e += kThreads) {
        const int which = e >= nvec;  // 0: K, 1: V
        const int r = e - which * nvec;
        const int t = r / kVecsPerRow, c = r - t * kVecsPerRow;
        const T* src = (which ? v_pool : k_pool) + base + t * tok_stride + c * kVec;
        cp_async16(st + (which * page + t) * DP + c * kVec, src);
      }
    }
    cp_async_commit();
  };

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();  // q, m, l are set

  for (int pi = 0; pi < npages; ++pi) {
    cp_async_wait<kStages - 2>();  // this thread's copies of page pi are done
    __syncthreads();  // ...everyone's; and stage (pi - 1) % kStages is free
    issue(pi + kStages - 1);
    const int n = kept_keys(pi, table[pi], page, seq_len);
    if (n <= 0) continue;  // uniform over the block
    const T* k_st = ring + (size_t)(pi % kStages) * 2 * page * DP;
    const T* v_st = k_st + page * DP;

    // scores: kLanesPerKey lanes per (row, key), dimensions interleaved
    for (int base = 0; base < g * page; base += kKeysPerPass) {
      const int e = base + tid / kLanesPerKey;
      const int r = e / page, t = e - r * page;
      const bool live = e < g * page && t < n;
      float dot = 0.f;
      if (live) {
        const float* qr = q_s + r * D + sub;
        const T* kr = k_st + t * DP + sub;
#pragma unroll
        for (int j = 0; j < kDimsPerLane; ++j)
          dot = fmaf(qr[j * kLanesPerKey], to_float(kr[j * kLanesPerKey]), dot);
      }
#pragma unroll
      for (int o = kLanesPerKey / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (live && sub == 0) {
        float sc = dot * scale;
        if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
        p_s[r * page + t] = sc;
      }
    }
    __syncthreads();

    // online softmax over the page's kept keys, one warp per row
    for (int r = warp; r < g; r += kWarps) {
      float* pr = p_s + r * page;
      float mc = kMasked;
      for (int t = lane; t < n; t += 32) mc = fmaxf(mc, pr[t]);
      mc = warp_max(mc);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V, each thread owning outputs tid + i * kThreads
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < g * D) {
        const int r = o / D, d = o - r * D;
        const float* pr = p_s + r * page;
        float a = acc[i] * a_s[r];
#pragma unroll 4
        for (int t = 0; t < n; ++t) a = fmaf(pr[t], to_float(v_st[t * DP + d]), a);
        acc[i] = a;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  T* ob = out + ((size_t)b * h + (size_t)kvh * g) * D;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < g * D) {
      const float l = l_s[o / D];
      ob[o] = from_float<T>(l == 0.f ? 0.f : acc[i] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* lens, void* out, int b, int h, int hkv, int page, int m,
           float scale, float softcap, cudaStream_t stream) {
  const int g = h / hkv;
  if (g * D > kMaxOut * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>(g, page);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, b);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), h, hkv, page, m, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (b, h, d), pools (n, page, hkv, d),
// tables (b, m) int32, seq_lens (b,) int32, out (b, h, d); pools 16-byte
// aligned (the wrapper checks).  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for an unsupported head dim,
// dtype or group width.  Launches on `stream`, allocates nothing, never
// synchronises.
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* seq_lens, void* out, int b, int h,
                               int hkv, int d, int page, int m, float scale,
                               float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T, DIM)                                                       \
  return launch<T, DIM>(q, k_pool, v_pool, tables, seq_lens, out, b, h, hkv, \
                        page, m, scale, softcap, st)
  if (dtype == 0 && d == 64) PA_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) PA_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) PA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) PA_LAUNCH(__nv_bfloat16, 128);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
