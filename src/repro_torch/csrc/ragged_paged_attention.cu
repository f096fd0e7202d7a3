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
// reads (and, at small batches, by launch latency and the few K/V tiles
// each job walks in series; key splits spread a few long sequences over
// the card).
//
// The fp32 version takes one block per (row tile, KV head, sequence), the
// bf16 one a job per (sequence, KV head, row tile, key split).  Either
// way a tile is a run of the Qmax * G grouped query rows (row r is slot
// r / G, head kvh * G + r % G), so the G query heads that share a KV head
// read each page once, and it walks only this sequence's keys up to
// min(kv_len, max q_pos of the tile + 1) -- every later key is masked for
// every row, so stopping there is exact -- where the TPU grid visits all M
// pages.
//
// bf16 (ragged_wg_kernel): warpgroup products (wgmma) fed by TMA through
// the block table, warp specialised and persistent (the flash kernel's
// design, with its consumer functions from csrc/wg_attention.cuh).  A job
// is one (sequence, KV head, row tile, key split): a row tile is
// P = 64 / G query slots of G heads (Qwen2-0.5B's G = 7: 9 slots, 63 rows),
// and a split is a run of whole 64-key tiles that the host picks from
// shapes alone (kernels/paged_attention.py::ragged_splits; the fused path
// reads nothing back).  The grid holds one block per SM; each block holds
// two pipelines at D <= 128 (one at D = 256), each a producer warp and a
// consumer warpgroup with its own q, K/V ring and barriers, and the card's
// pipelines take the jobs, last row tile and first split first, a round of
// one job each at a time in snake order.  The producer warp loads the job's
// q by one TMA box per atom column (slots x heads of the packed group, the
// flash kernel's q layout), then each 64-key tile of its split up to its
// last kept key into the next stage of a ring of 3 to 6 (full / empty
// mbarriers): the pool is the 4-d map {D, Hkv, page, N}, and a tile is
// 64 / R boxes of R = gcd(page, 64) rows per atom column, each at the
// block its sequence's table names (a -1 entry, or one past the table,
// reads page 0, and kv_len masks it), issued by one lane each after
// reading that entry while lane 0 waits for the stage.  A job with no key
// loads nothing and writes zeros (or, split, l = 0).  The consumer
// warpgroup owns the job's 64 rows: S = Q K^T into fp32 registers, the
// scale, softcap, per-row mask t < min(kv_len, q_pos + 1) (only on a tile
// some row keeps in part) and online softmax there, P in bf16 as the A
// operand of O += P V, S of one tile and P V of the one before in flight
// together, its softcap in a loop apart (softmax_tile<kN, true>: faster
// in a serve's decode step, PERF.md §6).  Unsplit, it writes O / l;
// split, the fp32 partials O, m and l (l = 0 and no O for a row that keeps
// none of the split's keys), which split_merge.cuh's merge_kernel combines
// by their log-sum-exp.
//   Registers: two pipelines are 10 warps, at most 3 on one of the SM's
//   16,384-register quarters: 168 registers a thread, where the consumers'
//   O, S and P (64 + 32 + 16 at D = 128) fit; D = 256 has one pipeline.
//   Shared memory is fixed per D (214,272 / 230,656 / 230,528 bytes at
//   D = 64 / 128 / 256), whatever the page or table width.
// The maps are encoded on the host at every call (csrc/wg_attention.cuh);
// the shared-memory attribute is set once per device.  A wait that never
// completes traps instead of hanging the card.
//
// fp32 (ragged_kernel): the CUDA cores, kept as it is to hold the port
// against the reference at fp32.  16-row tiles of 128 threads; each page is
// staged in shared memory as fp32, scores and probabilities live in shared
// memory, and each thread keeps D / 8 fp32 output accumulators of one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "split_merge.cuh"
#include "wg_attention.cuh"

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

// ------------------------------------------------- bf16 kernel for Hopper
using bf16 = __nv_bfloat16;
constexpr int kMaxSmem = 232448;
// returned when a tensor map cannot be encoded (no CUDA error stands for it)
constexpr int kTensorMapError = -1;

template <int D>
struct RgTile {
  // Pipelines of one producer warp and one consumer warpgroup of 64 rows:
  // two at D <= 128 (10 warps, at most 3 on one of the SM's four
  // 16,384-register quarters: 168 registers a thread, the flash kernel's
  // budget), one at D = 256, whose O alone takes 128 registers (5 warps:
  // 255).
  static constexpr int kPipes = D > 128 ? 1 : 2;
  static constexpr int kConsumers = 128 * kPipes;
  static constexpr int kThreads = 160 * kPipes;
  static constexpr int kW = wg::Atom<D>::kW;  // 64: 128-byte rows and swizzle
  static constexpr int kSpan = wg::Atom<D>::kSpan;
  static constexpr int kAtoms = wg::Atom<D>::kAtoms;
  static constexpr int kRows = 64;  // grouped query rows of a job
  static constexpr int kN = 64;     // keys per K/V tile
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kN * D * 2;  // K or V of one stage
  static constexpr int kBarBytes = 128;          // a pipeline's barriers
  static constexpr int kFit = ((kMaxSmem - 1024) / kPipes - kBarBytes - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kPipeBytes = kQBytes + 2 * kStages * kTileBytes;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period
  static constexpr int kSmem = 1024 + kPipes * (kPipeBytes + kBarBytes);
  static_assert(kW == 64, "ragged head dims are multiples of 64");
  static_assert(kStages >= 2 && 8 * (2 * kStages + 2) <= kBarBytes, "stages and barriers fit");
  static_assert(kSmem <= kMaxSmem, "one block per SM");
};

// One pipeline's shared memory, from the dynamic window's base rounded up
// to 1024 bytes: pipeline p's q [64 rows], K ring [kStages], V ring
// [kStages], one after the other; after every pipeline's tiles, the
// barriers full[kStages], empty[kStages], q_full, q_empty of each.
template <int D>
struct RgSmem {
  using C = RgTile<D>;
  uint32_t q, k, v, bars;
  __device__ __forceinline__ RgSmem(const void* raw, int pipe) {
    const uint32_t base = (hopper::smem_u32(raw) + 1023u) & ~1023u;
    q = base + pipe * C::kPipeBytes;
    k = q + C::kQBytes;
    v = k + C::kStages * C::kTileBytes;
    bars = base + C::kPipes * C::kPipeBytes + pipe * C::kBarBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (C::kStages + s); }
  __device__ __forceinline__ uint32_t q_full() const { return bars + 16u * C::kStages; }
  __device__ __forceinline__ uint32_t q_empty() const { return bars + 16u * C::kStages + 8u; }
};

// What every role of the kernel reads; shapes and the host's plan.
struct RgParams {
  const int* tables;   // (s, m), -1 padded
  const int* q_pos;    // (s, qmax)
  const int* kv_lens;  // (s,)
  bf16* out;           // (s, qmax, h, D)
  float* part_o;       // (nsplit, s * qmax * h, D) when nsplit > 1
  float* part_ml;      // (nsplit, s * qmax * h, 2) when nsplit > 1
  int s, qmax, h, hkv, page, m;
  int group;       // G = h / hkv
  int positions;   // P = 64 / G query slots per row tile
  int qbox;        // min(P, qmax): the slots q's TMA box brings
  int tiles;       // ceil(qmax / P) row tiles per (sequence, KV head)
  int nsplit;      // key splits
  int split_keys;  // keys per split, a multiple of 64
  int box_rows;    // R = gcd(page, 64): rows of a K/V box, inside one page
  float scale, softcap;
};

// One job: one (sequence, KV head, row tile, key split), worked out from its
// index by a whole warp (every lane gets the same answer), so that each role
// works it out for itself with no barrier between them.  Jobs go last row
// tile first (its slots sit furthest into their sequences), then split 0
// first, across every (sequence, KV head).
struct RgJob {
  int s, kvh, x, sp;  // sequence, KV head, row tile, split
  int kv_len;
  int t_lo, t_hi;  // the 64-key tiles it walks: its split's, up to its last kept key
  int hi_min;      // the least key end, min(kv_len, q_pos + 1), of its real rows
};

__device__ __forceinline__ int rg_jobs(const RgParams& p) {
  return p.tiles * p.nsplit * p.s * p.hkv;
}

// The job's coordinates, from its index alone.
__device__ __forceinline__ RgJob rg_coords(int job, const RgParams& p) {
  RgJob jb;
  jb.kvh = job % p.hkv;
  int rest = job / p.hkv;
  jb.s = rest % p.s;
  rest /= p.s;
  jb.sp = rest % p.nsplit;
  jb.x = p.tiles - 1 - rest / p.nsplit;
  return jb;
}

// The job's tiles and least row end, from kv_len and its slots' q_pos.
__device__ __forceinline__ void rg_range(RgJob& jb, const RgParams& p, int lane, int kn) {
  jb.kv_len = min(p.kv_lens[jb.s], p.m * p.page);  // no key lies past the table
  const int j0 = jb.x * p.positions;
  const int np = min(p.positions, p.qmax - j0);  // >= 1: row tiles start inside qmax
  int mx = -1, mn = 0x7fffffff;
  for (int i = lane; i < np; i += 32) {
    const int qp = p.q_pos[(size_t)jb.s * p.qmax + j0 + i];
    mx = max(mx, qp);
    mn = min(mn, qp);
  }
  mx = attn_tile::warp_max(mx);
  mn = attn_tile::warp_min(mn);
  // keys at or past min(kv_len, the largest q_pos + 1) are masked for every row
  const int kv_end = min(jb.kv_len, mx + 1);
  jb.hi_min = min(jb.kv_len, mn + 1);
  const int k_beg = jb.sp * p.split_keys;
  const int k_end = min(kv_end, k_beg + p.split_keys);
  jb.t_lo = k_beg / kn;
  jb.t_hi = k_end > k_beg ? (k_end + kn - 1) / kn : jb.t_lo;
}

// This pipeline's job of round r: the card's pipelines (`slots`) take the
// jobs a round at a time, in snake order (round r in reverse when r is odd)
// so that their shares of the heaviest-first list come out even; -1 past
// the end.
__device__ __forceinline__ int rg_job_of(int r, int slot, int slots, int jobs) {
  const int job = r * slots + (r & 1 ? slots - 1 - slot : slot);
  return job < jobs ? job : -1;
}

// A pipeline's producer warp.  Per job with a key, once its consumers are
// done with the last job's q (q_empty), lane 0 loads its q (the row tile's
// slots x the KV head's G heads, one box per atom column), then each K/V
// tile into the next stage of the ring once the consumers have freed it:
// lane b of the first 64 / R issues box b of every atom column of K and V,
// rows [b R, b R + R) of the tile, from the page its sequence's table names
// (an entry past the table or below 0 reads page 0: those keys are masked
// by kv_len).  Each lane reads its next box's table entry while lane 0
// waits for the stage.  The ring's stages and phases run on across jobs.
template <int D>
__device__ __forceinline__ void rg_produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, const RgSmem<D>& sm,
                                           const RgParams& p, int slot, int slots) {
  using C = RgTile<D>;
  constexpr int kN = C::kN, kS = C::kStages;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hopper::prefetch_map(q_map);
    hopper::prefetch_map(k_map);
    hopper::prefetch_map(v_map);
  }
  const int jobs = rg_jobs(p);
  const int nbox = kN / p.box_rows;
  const uint32_t q_bytes = (uint32_t)(p.qbox * p.group * D * 2);
  int g = 0, loaded = 0;  // K/V tiles and q tiles loaded so far
  for (int r = 0; r * slots < jobs; ++r) {
    const int job = rg_job_of(r, slot, slots, jobs);
    if (job < 0) continue;
    RgJob jb = rg_coords(job, p);
    const int* row = p.tables + (size_t)jb.s * p.m;
    int blk = 0, tok = 0;  // this lane's box: its page's block, and its first row there
    auto entry = [&](int t) {
      if (lane < nbox) {
        const int key = t * kN + lane * p.box_rows;
        const int pi = key / p.page;
        const int e = pi < p.m ? row[pi] : 0;
        blk = e < 0 ? 0 : e;
        tok = key - pi * p.page;
      }
    };
    entry(jb.sp * p.split_keys / kN);  // the first tile's, read beside q_pos and kv_len
    rg_range(jb, p, lane, kN);
    if (jb.t_hi <= jb.t_lo) continue;  // no key: the consumers write zeros
    if (lane == 0) {
      if (loaded > 0) hopper::mbar_wait(sm.q_empty(), (loaded - 1) & 1);
      hopper::mbar_expect_tx(sm.q_full(), q_bytes);
      for (int a = 0; a < C::kAtoms; ++a)
        hopper::tma_load_4d(sm.q + a * C::kRows * C::kSpan, q_map, sm.q_full(), a * C::kW,
                            jb.kvh * p.group, jb.x * p.positions, jb.s);
    }
    ++loaded;
    for (int t = jb.t_lo; t < jb.t_hi; ++t, ++g) {
      const int s = g % kS;
      if (lane == 0) {
        hopper::mbar_wait(sm.empty(s), ((g / kS) & 1) ^ 1);
        hopper::mbar_expect_tx(sm.full(s), 2u * C::kTileBytes);
      }
      __syncwarp();
      if (lane < nbox) {
        const uint32_t off = s * C::kTileBytes + lane * p.box_rows * C::kSpan;
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_4d(sm.k + off + a * kN * C::kSpan, k_map, sm.full(s), a * C::kW,
                              jb.kvh, tok, blk);
          hopper::tma_load_4d(sm.v + off + a * kN * C::kSpan, v_map, sm.full(s), a * C::kW,
                              jb.kvh, tok, blk);
        }
      }
      if (t + 1 < jb.t_hi) entry(t + 1);
    }
  }
}

// A consumer warpgroup on one job: its 64 rows, S = Q K^T, the online
// softmax and O += P V over the job's tiles (the ring's g0, g0 + 1, ...;
// its q the ring's k-th), then O / l into the rows' outputs, or with key
// splits the unnormalised O and (m, l) into the partials.
template <int D>
__device__ __forceinline__ void rg_consume_job(const RgSmem<D>& sm, const RgParams& p,
                                               const RgJob& jb, int g0, int k) {
  using C = RgTile<D>;
  constexpr int kN = C::kN, kS = C::kStages;
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int t_lo = jb.t_lo, t_hi = jb.t_hi;
  auto stage = [&](int t) { return (g0 + t - t_lo) % kS; };
  auto phase = [&](int t) { return ((g0 + t - t_lo) / kS) & 1; };

  // this thread's rows (lane / 4 and lane / 4 + 8 of its warp's 16): row r
  // is slot x P + r / G, head kvh G + r % G; it keeps the keys in [0, hi)
  int lo[2], hi[2], orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    const int j = jb.x * p.positions + r / p.group;
    if (r < p.positions * p.group && j < p.qmax) {
      const int qp = p.q_pos[(size_t)jb.s * p.qmax + j];
      lo[i] = 0;
      hi[i] = min(jb.kv_len, qp + 1);
      orow[i] = ((jb.s * p.qmax + j) * p.h) + jb.kvh * p.group + r % p.group;
    } else {
      lo[i] = attn_tile::kNoKey;
      hi[i] = -attn_tile::kNoKey;
      orow[i] = -1;
    }
  }
  const float qk_scale = p.scale * attn_tile::kLog2e;
  const float cap_in = p.softcap != 0.f ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * attn_tile::kLog2e;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (t_hi > t_lo) {
    float sc[kN / 2];        // S of the tile in hand
    uint32_t p_[kN / 16][4];  // bf16 P of the tile before it: the A operand of P V
    hopper::mbar_wait(sm.q_full(), k & 1);
    // the first tile: S, its softmax and P
    int prev = stage(t_lo);
    hopper::mbar_wait(sm.full(prev), phase(t_lo));
    hopper::wgmma_fence();
    wg::qk_product<D, kN, C::kRows>(sc, sm.q, sm.k + prev * C::kTileBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    float alpha[2];
    wg::softmax_tile<kN, true>(sc, m, l, alpha, t_lo * kN, lane, lo, hi, 0, jb.hi_min,
                               qk_scale, p.softcap, cap_in, cap_out);
    wg::pack_p<kN>(p_, sc);
    // the rest: S of tile t and O += P V of tile t - 1 in flight together,
    // then t's softmax while P V runs
    for (int t = t_lo + 1; t < t_hi; ++t) {
      const int s = stage(t);
      hopper::mbar_wait(sm.full(s), phase(t));
      hopper::wgmma_fence();
      wg::qk_product<D, kN, C::kRows>(sc, sm.q, sm.k + s * C::kTileBytes);
      hopper::wgmma_commit();
      wg::pv_product<D, kN>(o, p_, sm.v + prev * C::kTileBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is done; P V may still run
      hopper::fence_regs(sc);
      wg::softmax_tile<kN, true>(sc, m, l, alpha, t * kN, lane, lo, hi, 0, jb.hi_min,
                                 qk_scale, p.softcap, cap_in, cap_out);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(p_);
      hopper::mbar_arrive(sm.empty(prev));
      wg::rescale_o<D>(o, alpha);
      wg::pack_p<kN>(p_, sc);
      prev = s;
    }
    // the last P V
    hopper::wgmma_fence();
    wg::pv_product<D, kN>(o, p_, sm.v + prev * C::kTileBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p_);
    hopper::mbar_arrive(sm.empty(prev));
    hopper::mbar_arrive(sm.q_empty());  // done with q
  }

  // columns 8 j + 2 (lane % 4) + {0, 1} of rows r = 0, 1
  const size_t rows = (size_t)p.s * p.qmax * p.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = attn_tile::quad_sum(l[r]);
    if (orow[r] < 0) continue;
    if (p.nsplit == 1) {  // O / l with a safe l (a row that keeps no key: 0), bf16
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      bf16* dst = p.out + (size_t)orow[r] * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * (lane & 3)) =
            attn_tile::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      continue;
    }
    // this split's partials; a row that keeps none of its keys leaves l = 0
    // and no O, and takes no part in the merge
    const size_t prow = (size_t)jb.sp * rows + orow[r];
    if (lsum > 0.f) {
      float* dst = p.part_o + prow * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * (lane & 3)) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
    if ((lane & 3) == 0) reinterpret_cast<float2*>(p.part_ml)[prow] = make_float2(m[r], lsum);
  }
}

// A consumer warpgroup's jobs, in its producer's order.
template <int D>
__device__ __forceinline__ void rg_consume(const RgSmem<D>& sm, const RgParams& p, int slot,
                                           int slots) {
  using C = RgTile<D>;
  const int lane = threadIdx.x & 31;
  const int jobs = rg_jobs(p);
  int g = 0, k = 0;  // K/V tiles and q tiles consumed so far
  for (int r = 0; r * slots < jobs; ++r) {
    const int job = rg_job_of(r, slot, slots, jobs);
    if (job < 0) continue;
    RgJob jb = rg_coords(job, p);
    rg_range(jb, p, lane, C::kN);
    rg_consume_job<D>(sm, p, jb, g, k);
    if (jb.t_hi > jb.t_lo) {
      g += jb.t_hi - jb.t_lo;
      ++k;
    }
  }
}

// Warp-specialised and persistent: each block holds kPipes pipelines of a
// producer warp and a consumer warpgroup, each pipeline its own q, K/V ring
// and barriers, and the card's pipelines take the jobs in rounds.  A job's
// 64 rows are (query slot, query head of the group) pairs, row r = slot
// x P + r / G, head kvh G + r % G, P = 64 / G slots; the spare rows past
// P G (and slots past qmax) are zero and never stored.
template <int D>
__global__ void __launch_bounds__(RgTile<D>::kThreads, 1)
    ragged_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const RgParams p) {
  using C = RgTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (threadIdx.x == 0) {
    for (int pipe = 0; pipe < C::kPipes; ++pipe) {
      const RgSmem<D> sm(smem_raw, pipe);
      for (int s = 0; s < C::kStages; ++s) {
        hopper::mbar_init(sm.full(s), 1);
        hopper::mbar_init(sm.empty(s), 128);  // every consumer thread releases
      }
      hopper::mbar_init(sm.q_full(), 1);
      hopper::mbar_init(sm.q_empty(), 128);
    }
    hopper::mbar_init_fence();
  }
  // q rows past the box's qbox G are never loaded: zero them once
  const int live = p.qbox * p.group;
  if (live < C::kRows) {
    const uint32_t base = RgSmem<D>(smem_raw, 0).q - hopper::smem_u32(smem_raw);
    const int from = live * C::kSpan / 16, per = C::kRows * C::kSpan / 16;
    for (int e = threadIdx.x; e < C::kPipes * C::kAtoms * per; e += C::kThreads) {
      const int pipe = e / (C::kAtoms * per), rest = e - pipe * C::kAtoms * per;
      const int a = rest / per, x = rest - a * per;
      if (x >= from)
        reinterpret_cast<uint4*>(smem_raw + base + pipe * C::kPipeBytes)[a * per + x] =
            make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();

  // the warpgroup's index, visibly uniform across each warp
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int slots = gridDim.x * C::kPipes;
  if (wgi == C::kPipes) {  // the producer warps, one per pipeline
    const int pipe = ((int)threadIdx.x - C::kConsumers) / 32;
    rg_produce<D>(&q_map, &k_map, &v_map, RgSmem<D>(smem_raw, pipe), p,
                  blockIdx.x * C::kPipes + pipe, slots);
    return;
  }
  rg_consume<D>(RgSmem<D>(smem_raw, wgi), p, blockIdx.x * C::kPipes + wgi, slots);
}

// The rows of a K/V box: the largest power-of-two divisor of the page that
// divides 64 (a multiple of 8: the wrapper refuses other pages), so that a
// box never crosses a page and every box lands on a 1024-byte boundary.
constexpr int common_rows(int a, int b) { return b == 0 ? a : common_rows(b, a % b); }

template <int D>
int launch_wg(const void* q, const void* kp, const void* vp, const void* tables,
              const void* qpos, const void* kvlens, void* out, void* part_o, void* part_ml,
              int s, int qmax, int h, int hkv, int page, int n, int m, int nsplit,
              int split_keys, float scale, float softcap, cudaStream_t stream) {
  using C = RgTile<D>;
  const int group = h / hkv;
  if (group < 1 || group > C::kRows || page < 8 || page % 8 || nsplit < 1 ||
      split_keys < C::kN || split_keys % C::kN ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  RgParams p;
  p.tables = static_cast<const int*>(tables);
  p.q_pos = static_cast<const int*>(qpos);
  p.kv_lens = static_cast<const int*>(kvlens);
  p.out = static_cast<bf16*>(out);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.s = s;
  p.qmax = qmax;
  p.h = h;
  p.hkv = hkv;
  p.page = page;
  p.m = m;
  p.group = group;
  p.positions = C::kRows / group;
  p.qbox = p.positions < qmax ? p.positions : qmax;
  p.tiles = (qmax + p.positions - 1) / p.positions;
  p.nsplit = nsplit;
  p.split_keys = split_keys;
  p.box_rows = common_rows(page, C::kN);
  p.scale = scale;
  p.softcap = softcap;
  const long long jobs = (long long)p.tiles * nsplit * s * hkv;
  if (jobs > 0x7fffffffLL || (long long)s * qmax * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> devices{0};  // those the attribute is set on
  const int attr = wg::smem_attribute(devices, (const void*)ragged_wg_kernel<D>, C::kSmem);
  if (attr != 0) return attr;
  CUtensorMap q_map, k_map, v_map;
  if (!wg::encode_map(&q_map, q, s, qmax, h, D, (long long)qmax * h * D, C::kW, group, p.qbox,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::encode_map(&k_map, kp, n, page, hkv, D, (long long)page * hkv * D, C::kW, 1,
                      p.box_rows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::encode_map(&v_map, vp, n, page, hkv, D, (long long)page * hkv * D, C::kW, 1,
                      p.box_rows, CU_TENSOR_MAP_SWIZZLE_128B))
    return kTensorMapError;
  int device = 0, sms = 0;  // one block per SM: each fills one with its shared memory
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (jobs + C::kPipes - 1) / C::kPipes;
  const unsigned blocks = (unsigned)(want < sms ? want : sms);
  ragged_wg_kernel<D><<<blocks, C::kThreads, C::kSmem, stream>>>(q_map, k_map, v_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  return split_merge::launch_merge<D>(p.part_o, p.part_ml, p.out, s * qmax * h, nsplit, stream);
}

}  // namespace

// dtype: 0 = float32 (ragged_kernel), 1 = bfloat16 (ragged_wg_kernel, then
// merge_kernel when nsplit > 1); d = 64, 128 or 256.  q (s, qmax, h, d),
// pools (n, page, hkv, d), tables (s, m) int32, q_pos (s, qmax) int32,
// kv_lens (s,) int32, out (s, qmax, h, d), all contiguous; q and the pools
// 16-byte aligned (the wrapper checks).  fp32: the block's shared memory
// (ragged_paged_attention_smem_bytes) must fit the 232,448 bytes a block may
// opt into, so the wrapper refuses a page above that.  bf16 only: h / hkv
// <= 64, page a multiple of 8; the keys are cut into nsplit splits of
// split_keys (a multiple of 64) and, when nsplit > 1, part_o (nsplit, s,
// qmax, h, d) and part_ml (nsplit, s, qmax, h, 2) are fp32 workspaces.
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported head dim, dtype, group, page or
// split, or -1 if a tensor map cannot be encoded.  Launches on `stream`,
// allocates nothing, never synchronises.
extern "C" int ragged_paged_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* q_pos, const void* kv_lens, void* out,
                                      void* part_o, void* part_ml, int s, int qmax, int h,
                                      int hkv, int d, int page, int n, int m, int nsplit,
                                      int split_keys, float scale, float softcap,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_LAUNCH(T, DIM)                                                            \
  return launch<T, DIM>(q, k_pool, v_pool, tables, q_pos, kv_lens, out, s, qmax, h, \
                        hkv, page, m, scale, softcap, st)
  if (dtype == 0 && d == 64) RPA_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) RPA_LAUNCH(float, 128);
  if (dtype == 0 && d == 256) RPA_LAUNCH(float, 256);
#undef RPA_LAUNCH
#define RPA_LAUNCH_WG(DIM)                                                                \
  return launch_wg<DIM>(q, k_pool, v_pool, tables, q_pos, kv_lens, out, part_o, part_ml, \
                        s, qmax, h, hkv, page, n, m, nsplit, split_keys, scale, softcap, st)
  if (dtype == 1 && d == 64) RPA_LAUNCH_WG(64);
  if (dtype == 1 && d == 128) RPA_LAUNCH_WG(128);
  if (dtype == 1 && d == 256) RPA_LAUNCH_WG(256);
#undef RPA_LAUNCH_WG
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel that `dtype` and `d`
// launch for `rows` = Qmax * G grouped rows, `page` tokens per page and a
// table width of `m`, in bytes (0 if there is none).  The bf16 kernel's is
// fixed: its pipelines' q, K/V rings and barriers, whatever the shapes.
extern "C" long long ragged_paged_attention_smem_bytes(int dtype, int d, int rows, int page,
                                                       int m) {
  (void)rows;
  (void)m;
  if (dtype == 0 && d == 64) return (long long)(smem_floats<64>(page) * sizeof(float));
  if (dtype == 0 && d == 128) return (long long)(smem_floats<128>(page) * sizeof(float));
  if (dtype == 0 && d == 256) return (long long)(smem_floats<256>(page) * sizeof(float));
  if (dtype == 1 && d == 64) return (long long)RgTile<64>::kSmem;
  if (dtype == 1 && d == 128) return (long long)RgTile<128>::kSmem;
  if (dtype == 1 && d == 256) return (long long)RgTile<256>::kSmem;
  return 0;
}
