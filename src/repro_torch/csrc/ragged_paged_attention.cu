// Fused ragged paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py::ragged_paged_attention
// (Pallas body _ragged_kernel), the attention of every layer of every
// serving iteration.  One launch covers a whole mixed iteration: prefill
// chunks (q_len up to Qmax queries) and decodes (q_len = 1) alike.
//
// What it computes, per sequence s, query slot j and query head h:
//   score(t) = tanh((q . k_t) * D^-0.5 / cap) * cap   (cap = 0: no tanh)
//   keep(t)  = t <= q_pos[s, j]  and  t < kv_len[s]
//   out      = softmax over kept t of score, applied to v_t
// with masked scores at -1e30, an fp32 online softmax, and a safe divisor
// (l == 0 -> 1): a row that keeps no key (kv_len == 0) comes out 0.  GQA is
// grouped KV-head-major: query head kvh * G + g reads KV head kvh.  Table
// entries below 0 read page 0 (they are masked by kv_len anyway).
//
// What bounds it on this card: at serving shapes the kernel reads each K/V
// page of a sequence once per (KV head, row tile) and does 4 * D flops per
// (row, key), far below the ~295 flops per byte where the H100's tensor
// cores would be the limit, so it is bound by the bytes of the pages it
// reads (and, at small batches, by launch latency).
//
// What the design does about that: one thread block per (row tile, KV head,
// sequence); the tile is kRows of the Qmax * G grouped query rows, so the
// G query heads that share a KV head read each page once, and shared memory
// never depends on Qmax.  The block walks only this sequence's pages up to
// min(kv_len, max q_pos of the tile + 1) -- every later page is fully
// masked, so stopping there is exact -- where the TPU grid visits all M
// pages.  Each page is staged in shared memory as fp32 (bf16 converted by
// the intrinsics), scores and probabilities live in shared memory, and each
// thread keeps D / 8 fp32 output accumulators of one row in registers.
// Tensor-core (wgmma) tiles, TMA page loads and split-KV parallelism for
// long contexts are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                      // grouped query rows per block
constexpr int kThreadsPerRow = kThreads / kRows;  // 8 threads share one row
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

// Shared memory, in floats: q tile [kRows][D+1], K page [page][D+1],
// V page [page][D], scores/probabilities [kRows][page], then per-row m, l,
// alpha and q_pos.  The +1 pads keep the row-wise dot products off one bank.
template <int D>
__host__ __device__ constexpr size_t smem_floats(int page) {
  return (size_t)kRows * (D + 1) + (size_t)page * (D + 1) + (size_t)page * D +
         (size_t)kRows * page + 4 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ q_pos, const int* __restrict__ kv_lens,
                  T* __restrict__ out, int qmax, int h, int hkv, int page, int m,
                  float scale, float softcap) {
  constexpr int DP = D + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  const int tile = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int g = h / hkv;
  const int nrows = qmax * g;
  const int row0 = tile * kRows;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRows * DP;
  float* v_s = k_s + page * DP;
  float* p_s = v_s + page * D;
  float* m_s = p_s + kRows * page;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* qp_s = reinterpret_cast<int*>(a_s + kRows);

  // The tile's grouped query rows: row r -> (slot j = r / G, head g = r % G).
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e - (e / D) * D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < nrows) {
      const int j = row / g, gi = row - (row / g) * g;
      val = to_float(q[(((size_t)s * qmax + j) * h + (size_t)kvh * g + gi) * D + d]);
    }
    q_s[r * DP + d] = val;
  }
  if (tid < kRows) {
    const int row = row0 + tid;
    qp_s[tid] = row < nrows ? q_pos[(size_t)s * qmax + row / g] : -1;
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int kv_len = kv_lens[s];
  int max_q = -1;
  for (int r = 0; r < kRows; ++r) max_q = max(max_q, qp_s[r]);
  // keys at or past min(kv_len, max_q + 1) are masked for every row here
  const int kv_end = min(kv_len, max_q + 1);
  const int npages = kv_end > 0 ? min(m, (kv_end + page - 1) / page) : 0;

  const int ra = tid / kThreadsPerRow;  // this thread's accumulator row
  const int ca = tid - ra * kThreadsPerRow;  // and its first dimension
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const size_t tok_stride = (size_t)hkv * D;
  for (int pi = 0; pi < npages; ++pi) {
    int blk = tables[(size_t)s * m + pi];
    blk = blk < 0 ? 0 : blk;
    const size_t base = (size_t)blk * page * tok_stride + (size_t)kvh * D;
    __syncthreads();  // the previous page's readers are done with k_s/v_s/p_s
    for (int e = tid; e < page * D; e += kThreads) {
      const int t = e / D, d = e - (e / D) * D;
      const size_t off = base + t * tok_stride + d;
      k_s[t * DP + d] = to_float(k_pool[off]);
      v_s[t * D + d] = to_float(v_pool[off]);
    }
    __syncthreads();

    const int tok0 = pi * page;
    for (int e = tid; e < kRows * page; e += kThreads) {
      const int r = e / page, t = e - (e / page) * page;
      const float* qr = q_s + r * DP;
      const float* kr = k_s + t * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float sc = dot * scale;
      if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
      const int tok = tok0 + t;
      p_s[r * page + t] = (tok <= qp_s[r] && tok < kv_len) ? sc : kMasked;
    }
    __syncthreads();

    // online softmax, one warp per row (rows warp, warp + 4, ...)
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float mc = kMasked;
      for (int t = lane; t < page; t += 32) mc = fmaxf(mc, p_s[r * page + t]);
      mc = warp_max(mc);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(p_s[r * page + t] - m_new);
        p_s[r * page + t] = p;
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

    const float alpha = a_s[ra];
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    for (int t = 0; t < page; ++t) {
      const float p = p_s[ra * page + t];
      const float* vr = v_s + t * D + ca;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(p, vr[i * kThreadsPerRow], acc[i]);
    }
  }

  const int row = row0 + ra;
  if (row < nrows) {
    const float l = l_s[ra];
    const float safe_l = l == 0.f ? 1.f : l;
    // a row that keeps no key at all writes 0, as the plain version does
    const bool any = qp_s[ra] >= 0 && kv_len > 0;
    const int j = row / g, gi = row - (row / g) * g;
    T* o = out + (((size_t)s * qmax + j) * h + (size_t)kvh * g + gi) * D + ca;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      o[i * kThreadsPerRow] = from_float<T>(any ? acc[i] / safe_l : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* qpos, const void* kvlens, void* out, int s, int qmax,
           int h, int hkv, int page, int m, float scale, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(page) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = qmax * (h / hkv);
  dim3 grid((rows + kRows - 1) / kRows, hkv, s);
  ragged_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(qpos),
      static_cast<const int*>(kvlens), static_cast<T*>(out), qmax, h, hkv, page, m,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported head
// dim or dtype.  Launches on `stream`, allocates nothing, never synchronises.
extern "C" int ragged_paged_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* q_pos, const void* kv_lens,
                                      void* out, int s, int qmax, int h, int hkv,
                                      int d, int page, int m, float scale,
                                      float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_LAUNCH(T, DIM)                                                            \
  return launch<T, DIM>(q, k_pool, v_pool, tables, q_pos, kv_lens, out, s, qmax, h, \
                        hkv, page, m, scale, softcap, st)
  if (dtype == 0 && d == 64) RPA_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) RPA_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) RPA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) RPA_LAUNCH(__nv_bfloat16, 128);
#undef RPA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
