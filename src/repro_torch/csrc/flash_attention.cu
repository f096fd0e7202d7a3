// Flash attention over contiguous K/V for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _flash_kernel).  The port runs it in every layer of forward_full
// (models/layers.py::dense_attention) and of every prefill chunk of the
// contiguous serving path (models/layers.py::cached_attention on a full
// cache, against the cache's first q_offset + L slots).
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
// operations.  Short chunks (tens of queries) are bound by the K/V bytes
// of the context they read, and in practice by the latency of their few
// key tiles in series.
//
// bf16 (flash_tc_kernel): the tensor cores.  One block of 4 warps per
// (64-row query tile, query head, batch); each warp holds 16 query rows as
// mma.sync.m16n8k16 A-fragments (attention_tile.cuh; at D = 256 it reads
// them from the shared q tile per 16-deep chunk), and K/V tiles of 64
// keys stream through a two-stage ring of 16-byte cp.async copies, the next
// tile in flight while the current one is multiplied.  S = Q K^T, the
// online softmax and O += P V all stay in registers; P goes to bf16 once,
// straight from the S registers.  The key loop runs from the window's first
// key to the tile's last causal key and the heaviest causal tiles go first;
// within a tile each warp multiplies only the 16-key chunks its own rows
// keep, and computes masks only on chunks that straddle a causal, window
// or Tk edge.  Short query tiles (rows <= 32, e.g. a 31-token chunk of the
// contiguous serve) split each K/V tile's chunks among the block's warps
// (16 rows: 4 ways, 32 rows: 2 ways) and merge their (m, l, O) in shared
// memory at the end.  That was chosen over blocks of fewer rows because
// such calls are few blocks (32 on 132 SMs) each walking a short serial
// chain of K/V tiles: splitting a tile's keys among idle warps shortens
// every step of the chain without reading K/V twice, where smaller row
// tiles would make more blocks each read the same keys.  wgmma with TMA
// tile loads, warp specialisation and sharing a K/V tile among a group's G
// query heads are later work.
//
// fp32 (flash_kernel): the CUDA cores, kept as it is to hold the port
// against the reference at fp32 (a TF32 product would change those
// numbers).  One block of 256 threads per (64-row query tile, query head,
// batch); q in shared memory, the same two-stage K/V ring (one stage at
// D = 256, where two would need 351,232 bytes of shared memory against the
// 232,448 a block may have: the next tile's copies then wait for the
// current one's products); each thread
// holds a 2 x 8 block of the 64 x 64 score tile and 2 rows x D/8 columns of
// the accumulator in registers; the 8 lanes that share a row reduce its max
// and sum with shuffles, and the probabilities go through shared memory to
// the P V product.  A row's D / 4 four-float chunks go round the 8 lanes:
// at D = 80 (20 chunks) lanes 0-3 take three and lanes 4-7 two.
//
// Head dims: 64, 128, 256 and 80 (hubert-xlarge's encoder, non-causal).
// D = 80 needs nothing else of the bf16 kernel: its 5 16-deep chunks and
// 10 8-wide column tiles are whole, and its shared rows of 88 bf16 (176
// bytes, 44 words) start 12 words apart modulo 32, so the 8 rows of an
// ldmatrix phase still fall on 8 distinct 4-bank groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;

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
  static bool attribute_set = false;  // once per instantiation
  if (smem > 48 * 1024 && !attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  dim3 grid((tq + kRows - 1) / kRows, h, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, h, hkv, q_bstride, kv_bstride, q_offset, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 kernel
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = attn_tile::kWarps;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;        // query rows per block
constexpr int kTcKeys = attn_tile::kTileKeys;  // keys per K/V tile

// Shared memory: q [kTcRows][D + pad], then the K ring [2][kTcKeys][D + pad]
// and the V ring [2][kTcKeys][D + pad]; after the key loop the rings hold
// the split warps' partial (m, l, O).
template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return (size_t)(kTcRows + 4 * kTcKeys) * attn_tile::row_stride<D>() * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int tq, int tk,
                    int h, int hkv, long long q_bstride, long long kv_bstride,
                    int q_offset, int causal, int window, float scale, float softcap) {
  using Tile = attn_tile::WarpTile<D>;
  constexpr int S = attn_tile::row_stride<D>();
  constexpr int kRowChunks = D / 8;  // 16-byte chunks per row
  static_assert((kTcKeys * 4 * S * sizeof(bf16)) >=
                    (kTcWarps - 1) * 16 * Tile::kPartStride * sizeof(float),
                "the split warps' partials must fit in the K/V rings");
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * kTcRows;
  const int rows = min(kTcRows, tq - q0);  // real query rows of this tile

  const attn_tile::WarpRole role(rows, warp);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTcRows * S;
  bf16* v_s = k_s + 2 * kTcKeys * S;

  // Keys any row of the tile keeps lie in [k_lo, k_hi).
  int k_lo = 0, k_hi = tk;
  if (causal) k_hi = min(tk, q_offset + q0 + rows);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int t_lo = k_lo / kTcKeys;
  const int t_hi = k_hi > k_lo ? (k_hi + kTcKeys - 1) / kTcKeys : t_lo;

  const size_t q_tok = (size_t)h * D, kv_tok = (size_t)hkv * D;
  const bf16* qb = q + b * q_bstride + (size_t)head * D;
  const bf16* kb = k + b * kv_bstride + (size_t)kvh * D;
  const bf16* vb = v + b * kv_bstride + (size_t)kvh * D;

  // The tile's q rows (rows past Tq are zero); these copies join the first
  // K/V group.
  for (int e = tid; e < kTcRows * kRowChunks; e += kTcThreads) {
    const int r = e / kRowChunks, c = e - r * kRowChunks;
    bf16* dst = q_s + r * S + c * 8;
    if (r < rows) {
      cp_async16(dst, qb + (size_t)(q0 + r) * q_tok + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Every 16-byte copy of key tile t's K and V rows into its stage, then one
  // commit (an empty group past the last tile).  V rows past Tk up to the
  // next 16-key chunk are zeroed: P V multiplies them by p = 0.
  auto fetch = [&](int t) {
    if (t < t_hi) {
      const int k0 = t * kTcKeys;
      const int n = min(kTcKeys, tk - k0);
      const int st = (t - t_lo) & 1;
      bf16* ks = k_s + st * kTcKeys * S;
      bf16* vs = v_s + st * kTcKeys * S;
      const int nvec = n * kRowChunks;
      for (int e = tid; e < 2 * nvec; e += kTcThreads) {
        const int which = e >= nvec;  // 0: K, 1: V
        const int r = (e - which * nvec) / kRowChunks;
        const int c = (e - which * nvec) - r * kRowChunks;
        const size_t off = (size_t)(k0 + r) * kv_tok + c * 8;
        cp_async16((which ? vs : ks) + r * S + c * 8, (which ? vb : kb) + off);
      }
      const int pad = (((n + 15) & ~15) - n) * kRowChunks;
      for (int e = tid; e < pad; e += kTcThreads) {
        const int r = n + e / kRowChunks, c = e % kRowChunks;
        *reinterpret_cast<uint4*>(vs + r * S + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  // this lane's rows, lane / 4 and lane / 4 + 8 of the warp's 16, keep the
  // keys in [lo, hi)
  Tile w;
  {
    int lo[2], hi[2];
    bool exists[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * role.rw + (lane >> 2) + 8 * i;
      const int q_pos = q_offset + q0 + r;
      exists[i] = role.active && r < rows;
      lo[i] = window > 0 ? max(0, q_pos - window + 1) : 0;
      hi[i] = causal ? min(tk, q_pos + 1) : tk;
    }
    w.set_rows(lo, hi, exists);
  }

  fetch(t_lo);
  for (int t = t_lo; t < t_hi; ++t) {
    fetch(t + 1);
    cp_async_wait<1>();  // this thread's copies of tile t (and q) are done
    __syncthreads();     // ...everyone's
    if (role.active) {
      if (t == t_lo) w.load_q(q_s + 16 * role.rw * S, S);
      const int k0 = t * kTcKeys;
      int c0 = role.c0, c1 = role.c1;
      w.live_chunks(k0, c0, c1);
      if (c0 < c1) {
        const bool edge = !(k0 + 16 * c0 >= w.lo_max && k0 + 16 * c1 <= w.hi_min);
        const int st = (t - t_lo) & 1;
        w.tile(k_s + st * kTcKeys * S, v_s + st * kTcKeys * S, S, k0, c0, c1, edge,
               scale, softcap);
      }
    }
    __syncthreads();  // stage st is free for tile t + 2
  }
  cp_async_wait<0>();  // no copy outlives the block
  attn_tile::merge_splits(w, role, reinterpret_cast<float*>(k_s));
  if (!role.active || role.sp != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * role.rw + (lane >> 2) + 8 * i;
    if (r < rows) w.store_row(i, out + (((size_t)b * tq + q0 + r) * h + head) * D);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b, int tq,
              int tk, int h, int hkv, long long q_bstride, long long kv_bstride,
              int q_offset, int causal, int window, float scale, float softcap,
              cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool attribute_set = false;  // once per instantiation
  if (smem > 48 * 1024 && !attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  dim3 grid((tq + kTcRows - 1) / kTcRows, h, b);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), tq, tk, h, hkv, q_bstride, kv_bstride, q_offset, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (b, tq, h, d) and k, v (b, tk, hkv, d),
// each with its (t, head, d) part contiguous and batch strides q_bstride /
// kv_bstride in elements (k and v share theirs); out (b, tq, h, d)
// contiguous.  Every pointer and batch stride 16-byte aligned, h % hkv == 0,
// q_offset >= 0 (the wrapper checks).  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported head
// dim or dtype.  Launches on `stream`, allocates nothing, never synchronises.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int b, int tq, int tk, int h, int hkv, int d,
                               long long q_bstride, long long kv_bstride, int q_offset,
                               int causal, int window, float scale, float softcap,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DIM)                                                          \
  return launch<T, DIM>(q, k, v, out, b, tq, tk, h, hkv, q_bstride, kv_bstride, \
                        q_offset, causal, window, scale, softcap, st)
  if (dtype == 0 && d == 64) FA_LAUNCH(float, 64);
  if (dtype == 0 && d == 80) FA_LAUNCH(float, 80);
  if (dtype == 0 && d == 128) FA_LAUNCH(float, 128);
  if (dtype == 0 && d == 256) FA_LAUNCH(float, 256);
#undef FA_LAUNCH
#define FA_LAUNCH_TC(DIM)                                                           \
  return launch_tc<DIM>(q, k, v, out, b, tq, tk, h, hkv, q_bstride, kv_bstride, \
                        q_offset, causal, window, scale, softcap, st)
  if (dtype == 1 && d == 64) FA_LAUNCH_TC(64);
  if (dtype == 1 && d == 80) FA_LAUNCH_TC(80);
  if (dtype == 1 && d == 128) FA_LAUNCH_TC(128);
  if (dtype == 1 && d == 256) FA_LAUNCH_TC(256);
#undef FA_LAUNCH_TC
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel that `dtype` and `d`
// launch, in bytes (0 if there is none).
extern "C" long long flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0 && d == 64) return (long long)smem_bytes<float, 64>();
  if (dtype == 0 && d == 80) return (long long)smem_bytes<float, 80>();
  if (dtype == 0 && d == 128) return (long long)smem_bytes<float, 128>();
  if (dtype == 0 && d == 256) return (long long)smem_bytes<float, 256>();
  if (dtype == 1 && d == 64) return (long long)tc_smem_bytes<64>();
  if (dtype == 1 && d == 80) return (long long)tc_smem_bytes<80>();
  if (dtype == 1 && d == 128) return (long long)tc_smem_bytes<128>();
  if (dtype == 1 && d == 256) return (long long)tc_smem_bytes<256>();
  return 0;
}
