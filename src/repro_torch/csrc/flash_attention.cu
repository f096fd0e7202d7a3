// Flash attention over contiguous K/V for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _flash_kernel).  The port runs it in every layer of forward_full
// (models/layers.py::dense_attention) and of every prefill chunk of the
// contiguous serving path (models/layers.py::cached_attention on a full
// cache, against the cache's first q_offset + L slots), and in every call
// of the cross-attention (layers.cross_attention, non-causal).
//
// What it computes, per batch b, query row t and query head h:
//   q_pos    = q_offset + t
//   score(s) = tanh((q . k_s) * D^-0.5 / cap) * cap   (cap = 0: no tanh)
//   keep(s)  = s < Tk  and (not causal or s <= q_pos)
//              and (window = 0 or s > q_pos - window)
//   out      = softmax over kept s of score, applied to v_s
// with an fp32 online softmax.  Masked keys take no part at all (the plain
// version gives them -1e30, whose exp is exactly 0 next to a kept key), and
// a row that keeps no key comes out exactly 0, as the safe divisor gives.
// GQA: query head h reads KV head h / G.  Layout (B, T, H, D) with the
// (T, H, D) part contiguous; the batch strides are arguments, so a prefix
// view of a longer cache needs no copy.
//
// What bounds it on this card: causal prefill does 4 * D flops per kept
// (query head, query, key) triple against reading q, k, v once; at a few
// hundred tokens or more that is far above the ~295 flops per byte where
// the H100's bf16 tensor cores become the limit, so the bound is
// operations.  Short chunks (tens of queries) and single-query batches are
// bound by the K/V bytes they read, and in practice by the latency of their
// few key tiles in series.
//
// bf16 (flash_wg_kernel): warpgroup products (wgmma) fed by TMA, warp
// specialised and persistent.  A job is one (row tile, KV head, batch).
// Its rows are (query position, query head of the group) pairs, row r =
// position r / G and head r % G of the KV head's G query heads, so each K/V
// tile is read once for all G heads and a short chunk or a decode batch
// with G > 1 fills more of the rows; floor(rows / G) positions per job (the
// wrapper's plan), the spare rows zero and never stored.  The grid holds
// one block per SM; the blocks take the jobs, heaviest causal row tile
// first, a round of one job each at a time in snake order (every other
// round reversed), which evens out their shares of the causal work.  One
// producer thread loads each job's q (once the consumers are done with the
// last one's) and each K/V tile of 64 keys by TMA into a ring of up to 4
// stages (full / empty mbarriers, rows past Tk zero-filled), running on
// into the next job while the consumers store the last one's output; rows
// are 128-byte swizzled at D = 64, 128 and 256 and 32-byte at D = 80
// (160-byte rows: five 16-column atoms).  Each consumer warpgroup owns 64
// rows: S = Q K^T by wgmma from shared memory into fp32 registers, the
// scale, softcap, masks and online softmax there, P rounded to bf16 in
// registers as the A operand of O += P V, V read as it lies through the
// descriptor's transpose; S of tile t and P V of tile t - 1 are in flight
// together and t's softmax runs while P V does.  Key tiles run from the
// window's first key to the last causal key of the job, a warpgroup
// multiplies only its own live tiles and masks only tiles that straddle a
// causal, window or Tk edge.
//   D <= 128: two consumer warpgroups (128 rows) and a producer warp; 9
//   warps put 3 on one of the SM's 16,384-register quarters, so at most
//   168 registers a thread, and the consumers' O, S and P (at D = 128:
//   64 + 32 + 16) fit them with no spill.  setmaxnreg would move a
//   producer warpgroup's registers to the consumers at run time, but
//   ptxas still compiles the consumers to the launch's 168, so it changed
//   neither registers nor time and is not used (PERF.md, Findings).
//   D = 256: O alone takes 128 registers, so one consumer warpgroup (64
//   rows) and a producer warp: 5 warps, 255 registers a thread.
// The one rounding the CPU emulation models, P to bf16 before P V, is the
// only one besides the output's: scores, the softmax and every sum are fp32.
// The descriptors (q, K, V as 4-d tensor maps {D, H, T, B}) are encoded on
// the host at every call through cuTensorMapEncodeTiled, obtained from the
// runtime, so the library links no -lcuda.  A wait that never completes
// traps instead of hanging the card.  No second kernel for short calls:
// this one is faster than the mma.sync kernel it replaced on every timed
// input, the contiguous serve's 31-query chunks included (PERF.md, row 4).
// The consumers' tile functions (S, softmax, P, P V) and the maps' encoding
// live in csrc/wg_attention.cuh, shared with the bf16 ragged kernel.  Both
// versions set their shared-memory attribute once per device, not once per
// process: it belongs to the device's context.
//
// fp32 (flash_kernel): the CUDA cores, kept as it is to hold the port
// against the reference at fp32 (a TF32 product would change those
// numbers).  One block of 256 threads per (64-row query tile, query head,
// batch); q in shared memory, a two-stage K/V ring of 16-byte cp.async
// copies (one stage at D = 256, where two would need 351,232 bytes of
// shared memory against the 232,448 a block may have: the next tile's
// copies then wait for the current one's products); each thread holds a
// 2 x 8 block of the 64 x 64 score tile and 2 rows x D/8 columns of the
// accumulator in registers; the 8 lanes that share a row reduce its max and
// sum with shuffles, and the probabilities go through shared memory to the
// P V product.  A row's D / 4 four-float chunks go round the 8 lanes: at
// D = 80 (20 chunks) lanes 0-3 take three and lanes 4-7 two.
//
// Head dims: 64, 128, 256 and 80 (hubert-xlarge's encoder, non-causal).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "wg_attention.cuh"

namespace {

using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using wg::encode_map;
using wg::pack_p;
using wg::pv_product;
using wg::rescale_o;
using wg::softmax_tile;

constexpr int kThreads = 256;
constexpr int kRows = 64;                             // query rows per block
constexpr int kKeys = 64;                             // keys per K/V tile
constexpr int kLanesPerRow = 8;                       // lanes sharing a row
constexpr int kRowGroups = kThreads / kLanesPerRow;   // 32
constexpr int kRowsPerThread = kRows / kRowGroups;    // 2
constexpr int kKeysPerThread = kKeys / kLanesPerRow;  // 8
constexpr int kPStride = kKeys + 8;  // fp32 probability row, padded
constexpr float kMasked = -1e30f;

__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void store_vec(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ float row_max(float v) {  // over the 8 lanes of a row
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A shared q, K or V row is D elements plus a 16-byte pad, so the 8 lanes
// of a row group reading 8 different rows at one column hit 8 different
// 16-byte bank groups.
template <typename T, int D>
__host__ __device__ constexpr int row_elems() {
  return D + 16 / (int)sizeof(T);
}

// K/V tiles in the ring: two, or one where two do not fit (fp32, D = 256).
template <typename T, int D>
__host__ __device__ constexpr int stages() {
  return (kRows + 4 * kKeys) * row_elems<T, D>() * sizeof(T) + kRows * kPStride * sizeof(float) <=
                 232448
             ? 2
             : 1;
}

// Shared memory: q [kRows][row], K ring [stages][kKeys][row], V ring
// [stages][kKeys][row], then fp32 probabilities [kRows][kPStride].
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(kRows + 2 * stages<T, D>() * kKeys) * row_elems<T, D>() * sizeof(T) +
         (size_t)kRows * kPStride * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int tq, int tk,
                 int h, int hkv, long long q_bstride, long long kv_bstride,
                 int q_offset, int causal, int window, float scale, float softcap) {
  constexpr int kVec = 16 / (int)sizeof(T);        // elements per 16-byte copy
  constexpr int kChunks = D / kVec;                // 16-byte chunks per row
  constexpr int DP = row_elems<T, D>();
  // P V chunks per thread, the last one only on the lanes it exists for
  constexpr int kOutChunks = (kChunks + kLanesPerRow - 1) / kLanesPerRow;
  constexpr int kCols = kOutChunks * kVec;
  constexpr int kStages = stages<T, D>();
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRow, ty = tid / kLanesPerRow;
  const int q0 = tile * kRows;
  const int rows = min(kRows, tq - q0);  // real query rows of this tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kRows * DP;
  T* v_s = k_s + kStages * kKeys * DP;
  float* p_s = reinterpret_cast<float*>(v_s + kStages * kKeys * DP);

  // Keys any row of the tile keeps lie in [k_lo, k_hi).
  int k_lo = 0, k_hi = tk;
  if (causal) k_hi = min(tk, q_offset + q0 + rows);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int t_lo = k_lo / kKeys;
  const int t_hi = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys : t_lo;

  const size_t q_tok = (size_t)h * D, kv_tok = (size_t)hkv * D;
  const T* qb = q + b * q_bstride + (size_t)head * D;
  const T* kb = k + b * kv_bstride + (size_t)kvh * D;
  const T* vb = v + b * kv_bstride + (size_t)kvh * D;

  // The tile's q rows (rows past Tq are zero); these copies join the first
  // K/V group.
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    T* dst = q_s + r * DP + c * kVec;
    if (r < rows) {
      cp_async16(dst, qb + (size_t)(q0 + r) * q_tok + c * kVec);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Start every 16-byte copy of key tile t's K and V rows into its stage,
  // then commit them as one group (an empty group past the last tile).
  auto fetch = [&](int t) {
    if (t < t_hi) {
      const int k0 = t * kKeys;
      const int n = min(kKeys, tk - k0);
      const int st = (t - t_lo) % kStages;
      T* ks = k_s + st * kKeys * DP;
      T* vs = v_s + st * kKeys * DP;
      const int nvec = n * kChunks;
      for (int e = tid; e < 2 * nvec; e += kThreads) {
        const int which = e >= nvec;  // 0: K, 1: V
        const int r = (e - which * nvec) / kChunks;
        const int c = (e - which * nvec) - r * kChunks;
        const size_t off = (size_t)(k0 + r) * kv_tok + c * kVec;
        cp_async16((which ? vs : ks) + r * DP + c * kVec, (which ? vb : kb) + off);
      }
    }
    cp_async_commit();
  };

  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  float m_i[kRowsPerThread], l_i[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
  }

  fetch(t_lo);
  for (int t = t_lo; t < t_hi; ++t) {
    if (kStages == 2) {
      fetch(t + 1);
      cp_async_wait<1>();  // this thread's copies of tile t (and q) are done
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ...everyone's
    const int st = (t - t_lo) % kStages;
    const T* ks = k_s + st * kKeys * DP;
    const T* vs = v_s + st * kKeys * DP;
    const int k0 = t * kKeys;
    const int n = min(kKeys, tk - k0);

    // scores: rows ty + 32 i, keys tx + 8 j
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kChunks; ++c) {
      float qa[kRowsPerThread][kVec];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        load_vec(q_s + (ty + kRowGroups * i) * DP + c * kVec, qa[i]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        float kk[kVec];
        load_vec(ks + (tx + kLanesPerRow * j) * DP + c * kVec, kk);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) s[i][j] = fmaf(qa[i][e], kk[e], s[i][j]);
      }
    }

    // online softmax; the 8 lanes of a row hold its 64 scores
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + kRowGroups * i;
      const int q_pos = q_offset + q0 + r;
      unsigned kept = 0u;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int col = tx + kLanesPerRow * j;
        const int k_pos = k0 + col;
        const bool keep = col < n && (!causal || k_pos <= q_pos) &&
                          (window <= 0 || k_pos > q_pos - window);
        float sc = s[i][j] * scale;
        if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
        s[i][j] = keep ? sc : kMasked;
        kept |= (keep ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = (kept >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * kPStride + tx + kLanesPerRow * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the tile's probabilities are in p_s

    // acc += P V over the tile's real keys; columns (tx + 8 u) * kVec + e
#pragma unroll 2
    for (int key = 0; key < n; ++key) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = p_s[(ty + kRowGroups * i) * kPStride + key];
#pragma unroll
      for (int u = 0; u < kOutChunks; ++u) {
        if (kChunks % kLanesPerRow && tx + kLanesPerRow * u >= kChunks) continue;
        float vv[kVec];
        load_vec(vs + key * DP + (tx + kLanesPerRow * u) * kVec, vv);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][u * kVec + e] = fmaf(p[i], vv[e], acc[i][u * kVec + e]);
      }
    }
    __syncthreads();  // stage st and p_s are free for the next tiles
    if (kStages == 1) fetch(t + 1);
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + kRowGroups * i;
    if (r >= rows) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;  // no kept key: 0
    T* o = out + (((size_t)b * tq + q0 + r) * h + head) * D;
#pragma unroll
    for (int u = 0; u < kOutChunks; ++u) {
      if (kChunks % kLanesPerRow && tx + kLanesPerRow * u >= kChunks) continue;
      float vals[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = acc[i][u * kVec + e] * inv;
      store_vec(o + (tx + kLanesPerRow * u) * kVec, vals);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int tq,
           int tk, int h, int hkv, long long q_bstride, long long kv_bstride,
           int q_offset, int causal, int window, float scale, float softcap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static std::atomic<unsigned long long> devices{0};  // those the attribute is set on
  if (smem > 48 * 1024) {
    const int err = wg::smem_attribute(devices, (const void*)flash_kernel<T, D>, (int)smem);
    if (err != 0) return err;
  }
  dim3 grid((tq + kRows - 1) / kRows, h, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, h, hkv, q_bstride, kv_bstride, q_offset, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// ------------------------------------------------- bf16 kernel for Hopper
constexpr int kMaxSmem = 232448;
// returned when a tensor map cannot be encoded (no CUDA error stands for it)
constexpr int kTensorMapError = -1;

template <int D>
struct WgTile {
  // Consumer warpgroups of 64 rows, two, or one at D = 256, whose O alone
  // takes 128 registers a thread, and a producer warp.  Two consumers and
  // the producer are 9 warps, 3 on one of the SM's four 16,384-register
  // quarters: at most 168 registers a thread, where S, P and O must fit.
  // One consumer and the producer are 5 warps: 255 registers.
  static constexpr int kWgs = D > 128 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kConsumers = 128 * kWgs;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kW = wg::Atom<D>::kW;        // bf16 columns per swizzle atom
  static constexpr int kSpan = wg::Atom<D>::kSpan;  // bytes of an atom row (128 or 32)
  static constexpr int kLayout = wg::Atom<D>::kLayout;
  static constexpr int kAtoms = wg::Atom<D>::kAtoms;
  static constexpr int kN = 64;  // keys per K/V tile
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kN * D * 2;  // K or V of one stage
  static constexpr int kBarBytes = 256;
  static constexpr int kStagesFit = (kMaxSmem - 1024 - kBarBytes - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  static_assert(kStages >= 2, "two K/V stages must fit");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "tiles on 1024-byte bounds");
};

// Shared memory of a block, from the dynamic window's base rounded up to
// 1024 bytes: q [kRows rows], K ring [kStages], V ring [kStages], then the
// barriers full[kStages], empty[kStages], q_full, q_empty.
template <int D>
struct WgSmem {
  using C = WgTile<D>;
  uint32_t q, k, v, bars;
  __device__ __forceinline__ explicit WgSmem(const void* raw) {
    q = (hopper::smem_u32(raw) + 1023u) & ~1023u;
    k = q + C::kQBytes;
    v = k + C::kStages * C::kTileBytes;
    bars = v + C::kStages * C::kTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (C::kStages + s); }
  __device__ __forceinline__ uint32_t q_full() const { return bars + 16u * C::kStages; }
  __device__ __forceinline__ uint32_t q_empty() const { return bars + 16u * C::kStages + 8u; }
};

// One job: one (row tile, KV head, batch), worked out from its index alone,
// so that each role works it out for itself.  Jobs go heaviest causal row
// tile first, across every (batch, KV head), then the next tile.
struct WgJob {
  int q0, npos, kvh, b;  // first query position, positions, KV head, batch
  int t_lo, t_hi;        // the K/V tiles any of its rows keeps a key of
  __device__ __forceinline__ WgJob(int job, int kn, int batch, int tq, int tk, int hkv,
                                   int positions, int q_offset, int causal, int window) {
    const int per = hkv * batch, tiles = (tq + positions - 1) / positions;
    kvh = job % hkv;
    b = (job / hkv) % batch;
    q0 = (tiles - 1 - job / per) * positions;
    npos = min(positions, tq - q0);
    const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
    const int k_hi = causal ? min(tk, q_offset + q0 + npos) : tk;
    t_lo = k_lo / kn;
    t_hi = k_hi > k_lo ? (k_hi + kn - 1) / kn : t_lo;
  }
};

__device__ __forceinline__ int wg_jobs(int batch, int tq, int hkv, int positions) {
  return (tq + positions - 1) / positions * hkv * batch;
}

// This block's job of round r: the grid takes the jobs a round of gridDim.x
// at a time, in snake order (round r in reverse when r is odd), so that the
// blocks' shares of the heaviest-first list come out even; -1 past the end.
__device__ __forceinline__ int wg_job(int r, int jobs) {
  const int n = gridDim.x, x = blockIdx.x;
  const int job = r * n + (r & 1 ? n - 1 - x : x);
  return job < jobs ? job : -1;
}

// The producer: one thread issues every TMA copy.  Per job, once the
// consumers are done with the last job's q (q_empty), its q, then each K/V
// tile into the next stage of the ring once the consumers have freed it;
// the ring's stages and phases run on across jobs.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, const WgSmem<D>& sm,
                                        int batch, int tq, int tk, int hkv, int group,
                                        int positions, int q_offset, int causal, int window) {
  using C = WgTile<D>;
  constexpr int kN = C::kN, kS = C::kStages;
  hopper::prefetch_map(q_map);
  hopper::prefetch_map(k_map);
  hopper::prefetch_map(v_map);
  const int jobs = wg_jobs(batch, tq, hkv, positions);
  int g = 0, loaded = 0;  // K/V tiles and q tiles loaded so far
  for (int r = 0; r * (int)gridDim.x < jobs; ++r) {
    const int job = wg_job(r, jobs);
    if (job < 0) continue;
    const WgJob jb(job, kN, batch, tq, tk, hkv, positions, q_offset, causal, window);
    if (jb.t_hi <= jb.t_lo) continue;  // no key: the consumers write zeros
    if (loaded > 0) hopper::mbar_wait(sm.q_empty(), (loaded - 1) & 1);
    hopper::mbar_expect_tx(sm.q_full(), (uint32_t)(positions * group * D * 2));
    for (int a = 0; a < C::kAtoms; ++a)
      hopper::tma_load_4d(sm.q + a * C::kRows * C::kSpan, q_map, sm.q_full(), a * C::kW,
                          jb.kvh * group, jb.q0, jb.b);
    ++loaded;
    for (int t = jb.t_lo; t < jb.t_hi; ++t, ++g) {
      const int s = g % kS;
      hopper::mbar_wait(sm.empty(s), ((g / kS) & 1) ^ 1);
      hopper::mbar_expect_tx(sm.full(s), 2u * C::kTileBytes);
      const uint32_t ks = sm.k + s * C::kTileBytes, vs = sm.v + s * C::kTileBytes;
      for (int a = 0; a < C::kAtoms; ++a) {
        hopper::tma_load_4d(ks + a * kN * C::kSpan, k_map, sm.full(s), a * C::kW, jb.kvh,
                            t * kN, jb.b);
        hopper::tma_load_4d(vs + a * kN * C::kSpan, v_map, sm.full(s), a * C::kW, jb.kvh,
                            t * kN, jb.b);
      }
    }
  }
}

// A consumer warpgroup on one job: 64 rows of the block, S = Q K^T, the
// online softmax and O += P V over its live tiles, then O / l into the
// rows' outputs.  The job's K/V tiles are the ring's g0, g0 + 1, ... and its
// q the ring's k-th.
template <int D>
__device__ __forceinline__ void consume_job(const WgSmem<D>& sm, const WgJob& jb, int g0,
                                            int k, int wg, bf16* __restrict__ out, int tq,
                                            int tk, int h, int group, int q_offset,
                                            int causal, int window, float scale,
                                            float softcap) {
  using C = WgTile<D>;
  constexpr int kN = C::kN, kS = C::kStages;
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int nrows = jb.npos * group;  // real rows of the job
  const int q0 = jb.q0, t_lo = jb.t_lo, t_hi = jb.t_hi;
  auto stage = [&](int t) { return (g0 + t - t_lo) % kS; };
  auto phase = [&](int t) { return ((g0 + t - t_lo) / kS) & 1; };

  // this thread's rows (lane / 4 and lane / 4 + 8 of its warp's 16) keep
  // the keys in [lo, hi)
  auto lo_of = [&](int t) { return window > 0 ? max(0, q_offset + q0 + t - window + 1) : 0; };
  auto hi_of = [&](int t) { return causal ? min(tk, q_offset + q0 + t + 1) : tk; };
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
    lo[i] = r < nrows ? lo_of(r / group) : attn_tile::kNoKey;
    hi[i] = r < nrows ? hi_of(r / group) : -attn_tile::kNoKey;
  }
  // a tile needs masks unless every row of the warpgroup keeps all its keys
  // (lo and hi grow with the position)
  const int lo_max = lo_of(min(64 * wg + 63, nrows - 1) / group);
  const int hi_min = hi_of(64 * wg / group);

  const uint32_t q_wg = sm.q + 64 * wg * C::kSpan;
  const float qk_scale = scale * attn_tile::kLog2e;
  const float cap_in = softcap != 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * attn_tile::kLog2e;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sc[kN / 2];        // S of the tile in hand
  uint32_t p[kN / 16][4];  // bf16 P of the tile before it: the A operand of P V

  // The warpgroup's live tiles [ta, tb): those holding a key one of its
  // rows keeps.  The others only pass through its hands (a wait and a
  // release).
  int ta = t_lo, tb = t_lo;
  if (64 * wg < nrows) {
    ta = min(t_hi, max(t_lo, lo_of(64 * wg / group) / kN));
    tb = max(ta, min(t_hi, (hi_of(min(64 * wg + 63, nrows - 1) / group) + kN - 1) / kN));
  }
  auto pass = [&](int t) {  // a tile none of the warpgroup's rows keeps
    hopper::mbar_wait(sm.full(stage(t)), phase(t));
    hopper::mbar_arrive(sm.empty(stage(t)));
  };

  if (t_hi > t_lo) hopper::mbar_wait(sm.q_full(), k & 1);
  for (int t = t_lo; t < ta; ++t) pass(t);
  if (ta < tb) {
    // the first live tile: S, its softmax and P
    int prev = stage(ta);
    hopper::mbar_wait(sm.full(prev), phase(ta));
    hopper::wgmma_fence();
    wg::qk_product<D, kN, C::kRows>(sc, q_wg, sm.k + prev * C::kTileBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    float alpha[2];
    softmax_tile<kN>(sc, m, l, alpha, ta * kN, lane, lo, hi, lo_max, hi_min, qk_scale, softcap,
                     cap_in, cap_out);
    pack_p<kN>(p, sc);
    // the rest: S of tile t and O += P V of tile t - 1 in flight together,
    // then t's softmax while P V runs
    for (int t = ta + 1; t < tb; ++t) {
      const int s = stage(t);
      hopper::mbar_wait(sm.full(s), phase(t));
      hopper::wgmma_fence();
      wg::qk_product<D, kN, C::kRows>(sc, q_wg, sm.k + s * C::kTileBytes);
      hopper::wgmma_commit();
      pv_product<D, kN>(o, p, sm.v + prev * C::kTileBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is done; P V may still run
      hopper::fence_regs(sc);
      softmax_tile<kN>(sc, m, l, alpha, t * kN, lane, lo, hi, lo_max, hi_min, qk_scale,
                       softcap, cap_in, cap_out);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(p);
      hopper::mbar_arrive(sm.empty(prev));
      rescale_o<D>(o, alpha);
      pack_p<kN>(p, sc);
      prev = s;
    }
    // the last P V
    hopper::wgmma_fence();
    pv_product<D, kN>(o, p, sm.v + prev * C::kTileBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    hopper::mbar_arrive(sm.empty(prev));
  }
  for (int t = max(ta, tb); t < t_hi; ++t) pass(t);
  if (t_hi > t_lo) hopper::mbar_arrive(sm.q_empty());  // done with q

  // O / l with a safe l (a row that keeps no key: 0), bf16, into its
  // (position, head) row; columns 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = attn_tile::quad_sum(l[r]);
    const int rr = 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
    if (rr >= nrows) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    bf16* row = out + (((size_t)jb.b * tq + q0 + rr / group) * h +
                       (size_t)jb.kvh * group + rr % group) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * (lane & 3)) =
          attn_tile::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// A consumer warpgroup's jobs, in the producer's order.
template <int D>
__device__ __forceinline__ void consume(const WgSmem<D>& sm, int wg, bf16* __restrict__ out,
                                        int batch, int tq, int tk, int h, int hkv, int group,
                                        int positions, int q_offset, int causal, int window,
                                        float scale, float softcap) {
  using C = WgTile<D>;
  const int jobs = wg_jobs(batch, tq, hkv, positions);
  int g = 0, k = 0;  // K/V tiles and q tiles consumed so far
  for (int r = 0; r * (int)gridDim.x < jobs; ++r) {
    const int job = wg_job(r, jobs);
    if (job < 0) continue;
    const WgJob jb(job, C::kN, batch, tq, tk, hkv, positions, q_offset, causal, window);
    consume_job<D>(sm, jb, g, k, wg, out, tq, tk, h, group, q_offset, causal, window, scale,
                   softcap);
    if (jb.t_hi > jb.t_lo) {
      g += jb.t_hi - jb.t_lo;
      ++k;
    }
  }
}

// Warp-specialised and persistent: the consumer warpgroups own 64 rows
// each, the producer warp issues every TMA copy from one thread.  A block
// takes jobs of one (row tile, KV head, batch) in turn; a job's rows are
// (query position, query head of the group) pairs, row r = position r / G,
// head r % G of the KV head's group, `positions` = floor(rows / G)
// positions (the wrapper's plan), the spare rows zero and never stored.
template <int D>
__global__ void __launch_bounds__(WgTile<D>::kThreads, 1)
    flash_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                    int batch, int tq, int tk, int h, int hkv, int positions, int q_offset,
                    int causal, int window, float scale, float softcap) {
  using C = WgTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = h / hkv;
  {
    const WgSmem<D> sm(smem_raw);
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::kStages; ++s) {
        hopper::mbar_init(sm.full(s), 1);
        hopper::mbar_init(sm.empty(s), C::kConsumers);  // every consumer thread releases
      }
      hopper::mbar_init(sm.q_full(), 1);
      hopper::mbar_init(sm.q_empty(), C::kConsumers);
      hopper::mbar_init_fence();
    }
    // q rows past the block's pairs are never loaded: zero them once
    if (positions * group < C::kRows) {
      unsigned char* q = smem_raw + (sm.q - hopper::smem_u32(smem_raw));
      const int from = positions * group * C::kSpan / 16, per = C::kRows * C::kSpan / 16;
      for (int e = threadIdx.x; e < C::kAtoms * per; e += C::kThreads) {
        const int a = e / per, x = e - a * per;
        if (x >= from) reinterpret_cast<uint4*>(q)[a * per + x] = make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_proxy_async();
    }
  }
  __syncthreads();

  // the warpgroup's index, visibly uniform across each warp
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == C::kWgs) {
    if (threadIdx.x == C::kConsumers)
      produce<D>(&q_map, &k_map, &v_map, WgSmem<D>(smem_raw), batch, tq, tk, hkv, group,
                 positions, q_offset, causal, window);
    return;
  }
  consume<D>(WgSmem<D>(smem_raw), wgi, out, batch, tq, tk, h, hkv, group, positions, q_offset,
             causal, window, scale, softcap);
}

template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* out, int b, int tq, int tk,
              int h, int hkv, long long q_bstride, long long kv_bstride, int positions,
              int q_offset, int causal, int window, float scale, float softcap,
              cudaStream_t stream) {
  using C = WgTile<D>;
  const int group = h / hkv;
  if (positions < 1 || positions * group > C::kRows) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> devices{0};  // those the attribute is set on
  const int attr = wg::smem_attribute(devices, (const void*)flash_wg_kernel<D>, C::kSmem);
  if (attr != 0) return attr;
  const CUtensorMapSwizzle swizzle =
      C::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, b, tq, h, D, q_bstride, C::kW, group, positions, swizzle) ||
      !encode_map(&k_map, k, b, tk, hkv, D, kv_bstride, C::kW, 1, C::kN, swizzle) ||
      !encode_map(&v_map, v, b, tk, hkv, D, kv_bstride, C::kW, 1, C::kN, swizzle))
    return kTensorMapError;
  const long long jobs = (long long)((tq + positions - 1) / positions) * hkv * b;
  if (jobs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;  // one block per SM: each fills one with its shared memory
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(jobs < sms ? jobs : sms);
  flash_wg_kernel<D><<<blocks, C::kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), b, tq, tk, h, hkv, positions, q_offset,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (b, tq, h, d) and k, v (b, tk, hkv, d),
// each with its (t, head, d) part contiguous and batch strides q_bstride /
// kv_bstride in elements (k and v share theirs); out (b, tq, h, d)
// contiguous.  Every pointer and batch stride 16-byte aligned, h % hkv == 0,
// q_offset >= 0 (the wrapper checks).  `positions`: query positions per
// block of the bf16 kernel, 1 <= positions * (h / hkv) <= 128 (the
// wrapper's plan; fp32 ignores it).  Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for an unsupported head dim,
// dtype or plan, or -1 if a tensor map cannot be encoded.  Launches on
// `stream`, allocates nothing, never synchronises.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int b, int tq, int tk, int h, int hkv, int d,
                               long long q_bstride, long long kv_bstride, int positions,
                               int q_offset, int causal, int window, float scale,
                               float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DIM)                                                          \
  return launch<T, DIM>(q, k, v, out, b, tq, tk, h, hkv, q_bstride, kv_bstride, \
                        q_offset, causal, window, scale, softcap, st)
  if (dtype == 0 && d == 64) FA_LAUNCH(float, 64);
  if (dtype == 0 && d == 80) FA_LAUNCH(float, 80);
  if (dtype == 0 && d == 128) FA_LAUNCH(float, 128);
  if (dtype == 0 && d == 256) FA_LAUNCH(float, 256);
#undef FA_LAUNCH
#define FA_LAUNCH_WG(DIM)                                                                    \
  return launch_wg<DIM>(q, k, v, out, b, tq, tk, h, hkv, q_bstride, kv_bstride, positions, \
                        q_offset, causal, window, scale, softcap, st)
  if (dtype == 1 && d == 64) FA_LAUNCH_WG(64);
  if (dtype == 1 && d == 80) FA_LAUNCH_WG(80);
  if (dtype == 1 && d == 128) FA_LAUNCH_WG(128);
  if (dtype == 1 && d == 256) FA_LAUNCH_WG(256);
#undef FA_LAUNCH_WG
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel that `dtype` and `d`
// launch, in bytes (0 if there is none).
extern "C" long long flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0 && d == 64) return (long long)smem_bytes<float, 64>();
  if (dtype == 0 && d == 80) return (long long)smem_bytes<float, 80>();
  if (dtype == 0 && d == 128) return (long long)smem_bytes<float, 128>();
  if (dtype == 0 && d == 256) return (long long)smem_bytes<float, 256>();
  if (dtype == 1 && d == 64) return (long long)WgTile<64>::kSmem;
  if (dtype == 1 && d == 80) return (long long)WgTile<80>::kSmem;
  if (dtype == 1 && d == 128) return (long long)WgTile<128>::kSmem;
  if (dtype == 1 && d == 256) return (long long)WgTile<256>::kSmem;
  return 0;
}
