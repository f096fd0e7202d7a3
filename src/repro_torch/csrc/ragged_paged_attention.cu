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
// with an fp32 online softmax; masked keys take no part, and a row that
// keeps no key (kv_len == 0) comes out 0, as the Pallas kernel's safe
// divisor gives.  GQA is grouped KV-head-major: query head kvh * G + g
// reads KV head kvh.  Table entries below 0 read page 0 (they are masked by
// kv_len anyway).
//
// What bounds it on this card: at serving shapes the kernel reads each K/V
// page of a sequence once per (KV head, row tile) and does 4 * D flops per
// (row, key), far below the ~295 flops per byte where the H100's tensor
// cores would be the limit, so it is bound by the bytes of the pages it
// reads (and, at small batches, by launch latency and the few rounds of
// page loads each block walks in series).
//
// Both versions: one block per (row tile, KV head, sequence), where the
// tile is a run of the Qmax * G grouped query rows (row r is slot r / G,
// head kvh * G + r % G), so the G query heads that share a KV head read
// each page once.  The block walks only this sequence's keys up to
// min(kv_len, max q_pos of the tile + 1) -- every later key is masked for
// every row, so stopping there is exact -- where the TPU grid visits all M
// pages.
//
// bf16 (ragged_tc_kernel): blocks of 4 warps over a tile of up to 64
// grouped rows, one warp per 16 rows (attention_tile.cuh: mma.sync bf16,
// fp32 online softmax in registers; at D = 256 q's fragments are read from
// the shared q rows per 16-deep chunk).  Where the rows need fewer warps --
// a Llama-2-7B decode step (Qmax = 1, G = 1) has one row per block -- the
// warps that share rows split each round's 16-key chunks 2 or 4 ways and
// merge their (m, l, O) in shared memory at the end: a block of one warp
// would issue every copy and every mma of its sequence in series, with too
// few such blocks per SM (shared memory holds two) to hide the latency.
// The table row goes to shared memory once; keys then come in rounds of 64
// (4 pages of 16), and every K and V row of a round is a set of 16-byte
// cp.async copies issued one round ahead into a two-stage ring, so the next
// round's pages are in flight while this one is multiplied.  Each warp
// multiplies only the 16-key chunks its rows keep, masks only chunks that
// straddle a q_pos or kv_len edge, and skips every round past its rows'
// last q_pos: a warp of padded slots (q_pos = 0) does one chunk of one
// round.  Split-KV across blocks for few (sequence, KV head) pairs and
// wgmma with TMA page loads are later work.
//
// fp32 (ragged_kernel): the CUDA cores, kept as it is to hold the port
// against the reference at fp32.  16-row tiles of 128 threads; each page is
// staged in shared memory as fp32, scores and probabilities live in shared
// memory, and each thread keeps D / 8 fp32 output accumulators of one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                      // grouped query rows per block
constexpr int kThreadsPerRow = kThreads / kRows;  // 8 threads share one row
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
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

// ------------------------------------------------------------ bf16 kernel
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = attn_tile::kWarps;
constexpr int kTcRows = 16 * kTcWarps;            // grouped rows per block
constexpr int kRoundKeys = attn_tile::kTileKeys;  // keys per round of pages

// 16-row groups of q a block stages: as many as Qmax * G rows need.
__host__ __device__ inline int q_groups(int rows) {
  const int w = (rows + 15) / 16;
  return w < kTcWarps ? w : kTcWarps;
}

// Shared memory: the K ring [2][kRoundKeys][D + pad] and the V ring (after
// the key loop: the split warps' partial (m, l, O)), the q rows
// [16 * groups][D + pad], the table row [m] and the warps' last keys.
template <int D>
__host__ __device__ inline size_t tc_smem_bytes(int groups, int m) {
  return (size_t)(4 * kRoundKeys + 16 * groups) * attn_tile::row_stride<D>() *
             sizeof(bf16) +
         (size_t)(m + kTcWarps) * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps, 2)
    ragged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                     const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ q_pos, const int* __restrict__ kv_lens,
                     bf16* __restrict__ out, int qmax, int h, int hkv, int page, int m,
                     float scale, float softcap) {
  using Tile = attn_tile::WarpTile<D>;
  constexpr int S = attn_tile::row_stride<D>();
  constexpr int kRowChunks = D / 8;  // 16-byte chunks per row
  static_assert((kRoundKeys * 4 * S * sizeof(bf16)) >=
                    (kTcWarps - 1) * 16 * Tile::kPartStride * sizeof(float),
                "the split warps' partials must fit in the K/V rings");
  constexpr int nthreads = 32 * kTcWarps;
  const int tile = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int grp = h / hkv;
  const int nrows = qmax * grp;
  const int groups = q_groups(nrows);
  const int row0 = tile * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const attn_tile::WarpRole role(min(kTcRows, nrows - row0), warp);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + 2 * kRoundKeys * S;
  bf16* q_s = v_s + 2 * kRoundKeys * S;
  int* tbl_s = reinterpret_cast<int*>(q_s + 16 * groups * S);
  int* end_s = tbl_s + m;

  // This lane's rows (lane / 4 and lane / 4 + 8 of the warp's 16) keep the
  // keys in [0, min(kv_len, q_pos + 1)).
  const int kv_len = kv_lens[s];
  Tile w;
  {
    int lo[2] = {0, 0}, hi[2];
    bool exists[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * role.rw + (lane >> 2) + 8 * i;
      exists[i] = role.active && row < nrows;
      hi[i] = exists[i] ? min(kv_len, q_pos[(size_t)s * qmax + row / grp] + 1) : 0;
    }
    w.set_rows(lo, hi, exists);
  }
  if (lane == 0) end_s[warp] = w.hi_max;

  // The tile's q rows (rows past Qmax * G are zero); these copies join the
  // first round's group.
  const size_t q_seq = (size_t)s * qmax * h * D;
  for (int e = tid; e < 16 * groups * kRowChunks; e += nthreads) {
    const int r = e / kRowChunks, c = e - r * kRowChunks;
    const int row = row0 + r;
    bf16* dst = q_s + r * S + c * 8;
    if (row < nrows) {
      const int j = row / grp, gi = row - j * grp;
      attn_tile::cp_async16(dst, q + q_seq + ((size_t)j * h + (size_t)kvh * grp + gi) * D + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  // keys at or past min(kv_len, max q_pos of the tile + 1) are masked for
  // every row here
  int kv_end = 0;
  for (int i = 0; i < kTcWarps; ++i) kv_end = max(kv_end, end_s[i]);
  kv_end = min(kv_end, m * page);
  const int npages = (kv_end + page - 1) / page;
  for (int i = tid; i < npages; i += nthreads) {
    const int blk = tables[(size_t)s * m + i];
    tbl_s[i] = blk < 0 ? 0 : blk;
  }
  __syncthreads();

  const int pshift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  const size_t tok_stride = (size_t)hkv * D;  // elements between a page's tokens
  const bf16* kb = k_pool + (size_t)kvh * D;
  const bf16* vb = v_pool + (size_t)kvh * D;
  const int nrounds = (kv_end + kRoundKeys - 1) / kRoundKeys;

  // Every 16-byte copy of round rd's K and V rows into its stage, then one
  // commit (an empty group past the last round).  V rows past kv_end up to
  // the next 16-key chunk are zeroed: P V multiplies them by p = 0.
  auto fetch = [&](int rd) {
    if (rd < nrounds) {
      const int k0 = rd * kRoundKeys;
      const int n = min(kRoundKeys, kv_end - k0);
      bf16* ks = k_s + (rd & 1) * kRoundKeys * S;
      bf16* vs = v_s + (rd & 1) * kRoundKeys * S;
      const int nvec = n * kRowChunks;
      for (int e = tid; e < 2 * nvec; e += nthreads) {
        const int which = e >= nvec;  // 0: K, 1: V
        const int r = (e - which * nvec) / kRowChunks;
        const int c = (e - which * nvec) - r * kRowChunks;
        const int t = k0 + r;
        const int pi = pshift >= 0 ? t >> pshift : t / page;
        const size_t off = ((size_t)tbl_s[pi] * page + (t - pi * page)) * tok_stride + c * 8;
        attn_tile::cp_async16((which ? vs : ks) + r * S + c * 8, (which ? vb : kb) + off);
      }
      const int pad = (((n + 15) & ~15) - n) * kRowChunks;
      for (int e = tid; e < pad; e += nthreads) {
        const int r = n + e / kRowChunks, c = e % kRowChunks;
        *reinterpret_cast<uint4*>(vs + r * S + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    attn_tile::cp_async_commit();
  };

  fetch(0);
  for (int rd = 0; rd < nrounds; ++rd) {
    fetch(rd + 1);
    attn_tile::cp_async_wait<1>();  // this thread's copies of round rd (and q)
    __syncthreads();                 // ...everyone's
    if (rd == 0 && role.active) w.load_q(q_s + 16 * role.rw * S, S);
    const int k0 = rd * kRoundKeys;
    int c0 = role.c0, c1 = role.c1;
    w.live_chunks(k0, c0, c1);
    if (role.active && c0 < c1) {
      const bool edge = !(k0 + 16 * c0 >= w.lo_max && k0 + 16 * c1 <= w.hi_min);
      w.tile(k_s + (rd & 1) * kRoundKeys * S, v_s + (rd & 1) * kRoundKeys * S, S, k0, c0,
             c1, edge, scale, softcap);
    }
    __syncthreads();  // stage rd & 1 is free for round rd + 2
  }
  attn_tile::cp_async_wait<0>();  // no copy outlives the block
  attn_tile::merge_splits(w, role, reinterpret_cast<float*>(k_s));
  if (!role.active || role.sp != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * role.rw + (lane >> 2) + 8 * i;
    if (row < nrows) {
      const int j = row / grp, gi = row - j * grp;
      w.store_row(i, out + q_seq + ((size_t)j * h + (size_t)kvh * grp + gi) * D);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* kp, const void* vp, const void* tables,
              const void* qpos, const void* kvlens, void* out, int s, int qmax, int h,
              int hkv, int page, int m, float scale, float softcap, cudaStream_t stream) {
  const int rows = qmax * (h / hkv);
  const size_t smem = tc_smem_bytes<D>(q_groups(rows), m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((rows + kTcRows - 1) / kTcRows, hkv, s);
  ragged_tc_kernel<D><<<grid, 32 * kTcWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(qpos),
      static_cast<const int*>(kvlens), static_cast<bf16*>(out), qmax, h, hkv, page, m, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d = 64, 128 or 256.  The block's
// shared memory (ragged_paged_attention_smem_bytes) must fit the 232,448
// bytes a block may opt into: the wrapper refuses a page or table width
// above that.  Returns cudaGetLastError() after the
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
  if (dtype == 0 && d == 256) RPA_LAUNCH(float, 256);
#undef RPA_LAUNCH
#define RPA_LAUNCH_TC(DIM)                                                             \
  return launch_tc<DIM>(q, k_pool, v_pool, tables, q_pos, kv_lens, out, s, qmax, h, \
                        hkv, page, m, scale, softcap, st)
  if (dtype == 1 && d == 64) RPA_LAUNCH_TC(64);
  if (dtype == 1 && d == 128) RPA_LAUNCH_TC(128);
  if (dtype == 1 && d == 256) RPA_LAUNCH_TC(256);
#undef RPA_LAUNCH_TC
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel that `dtype` and `d`
// launch for `rows` = Qmax * G grouped rows, `page` tokens per page and a
// table width of `m`, in bytes (0 if there is none).
extern "C" long long ragged_paged_attention_smem_bytes(int dtype, int d, int rows, int page,
                                                       int m) {
  if (dtype == 0 && d == 64) return (long long)(smem_floats<64>(page) * sizeof(float));
  if (dtype == 0 && d == 128) return (long long)(smem_floats<128>(page) * sizeof(float));
  if (dtype == 0 && d == 256) return (long long)(smem_floats<256>(page) * sizeof(float));
  if (dtype == 1 && d == 64) return (long long)tc_smem_bytes<64>(q_groups(rows), m);
  if (dtype == 1 && d == 128) return (long long)tc_smem_bytes<128>(q_groups(rows), m);
  if (dtype == 1 && d == 256) return (long long)tc_smem_bytes<256>(q_groups(rows), m);
  return 0;
}
