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
// are visited; a negative table entry is never used as a page index (the
// fp32 kernel skips its page, the bf16 kernel reads page 0 in its place
// and masks its keys).  GQA is grouped KV-head-major: query head
// kvh * G + g reads KV head kvh.
//
// What bounds it on this card: it reads every K/V page up to each seq_len
// once per KV head, plus q, the table entries and seq_lens, and writes the
// output; it does 4 * D flops per (query head, key), about G / 2 flops per
// byte of K/V (bf16) -- far below the ~295 flops per byte where the H100's
// tensor cores would be the limit.  So its bound is those bytes over the
// HBM rate (3.35 TB/s).
//
// bf16 (paged_tc_kernel, merge_kernel): one block of 4 warps per (KV head,
// sequence, key split) on the tensor cores, through the warp tile of
// attention_tile.cuh (mma.sync bf16, fp32
// online softmax in registers, P rounded to bf16 before P V; q's fragments
// read from the shared q rows per 16-deep chunk at D = 256).  The tile's
// 16 rows are the G query heads of the (sequence, KV head) -- G = 1 for
// Llama-2-7B, 7 for Qwen2-0.5B; the rows past G are masked -- so each page
// is read once for the whole group.  The sequence's table entries go to
// shared memory once; keys then come in rounds of 64, every K and V row a
// set of 16-byte cp.async copies issued one round ahead into a two-stage
// ring, each key's page worked out inside the round (any page size).  The
// block's warps split each round's four 16-key chunks and merge their
// (m, l, O) in shared memory at the end (at G <= 16; 2 warps of rows and 2
// ways at G <= 32, no split above).  A -1 table entry inside a context is
// read as page 0, as the Pallas kernel reads it, and its keys are masked:
// where a split has one, each round's keys are taken as runs between -1
// entries, so the common path carries no per-key mask.  Every instruction
// counts at serving shapes, where a block walks 2 or 3 rounds: the copies
// compute one offset per key for its K and V rows, and the table entries
// are requested beside seq_len.
// The tensor cores here do not set the pace -- the kernel does about G / 2
// flops per byte -- they only shorten each round's chain of dependent
// work, which is what kept the CUDA-core design at 2x its bound.
//
// Split-KV: where (sequence, KV head) pairs are too few to fill the card,
// the host cuts the table's key range into `nsplit` splits of whole rounds
// (from shapes alone, never from seq_lens: the split path reads nothing
// back).  Each split block writes its unnormalised O, its max m and sum l
// in fp32 to a workspace, a split past seq_len writes l = 0, and
// merge_kernel (split_merge.cuh, shared with the bf16 ragged kernel)
// combines the splits by their log-sum-exp and writes the output; with one
// split the block writes the output itself.
//
// fp32 (decode_kernel): the CUDA cores, kept as it is to hold the port
// against the reference at fp32: one block per (KV head, sequence) holds
// that head's G query rows, pages stream through a ring of stages<D>()
// shared-memory stages (4; 2 at D = 256, where 4 pages of 32 would take
// 266,240 bytes) with 16-byte cp.async copies issued stages - 1 pages
// ahead, scores and probabilities live in shared memory and each thread
// keeps kOut fp32 outputs: 8, 16 or 32, the fewest that cover G * D over
// the block's 128 threads (command-r-plus-104b: G * D = 12 * 128 = 1536,
// so 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "split_merge.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;                          // lanes of one dot product
constexpr int kKeysPerPass = kThreads / kLanesPerKey;    // 16
constexpr int kMaxOut = 32;                              // outputs per thread: G * D <= 4096
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

// Pages in the ring.
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 128 ? 2 : 4;
}

// Shared memory: the ring [stages][K, V][page][row], then in floats
// q [G][D], scores/probabilities [G][page], and per-row m, l, alpha.
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int g, int page) {
  return (size_t)stages<D>() * 2 * page * row_elems<T, D>() * sizeof(T) +
         (size_t)(g * D + g * page + 3 * g) * sizeof(float);
}

// Keys of page pi that are kept: none if its table entry is negative.
__device__ __forceinline__ int kept_keys(int pi, int blk, int page, int seq_len) {
  return blk < 0 ? 0 : min(page, seq_len - pi * page);
}

template <typename T, int D, int kOut>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ seq_lens, T* __restrict__ out, int h,
                  int hkv, int page, int m, float scale, float softcap) {
  constexpr int DP = row_elems<T, D>();
  constexpr int kVec = 16 / (int)sizeof(T);       // elements per 16-byte copy
  constexpr int kVecsPerRow = D / kVec;
  constexpr int kDimsPerLane = D / kLanesPerKey;
  constexpr int kStages = stages<D>();
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

  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

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
    for (int i = 0; i < kOut; ++i) {
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
  for (int i = 0; i < kOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < g * D) {
      const float l = l_s[o / D];
      ob[o] = from_float<T>(l == 0.f ? 0.f : acc[i] / l);
    }
  }
}

template <typename T, int D, int kOut>
int launch_out(const void* q, const void* kp, const void* vp, const void* tables,
               const void* lens, void* out, int b, int h, int hkv, int page, int m,
               float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(h / hkv, page);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D, kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, b);
  decode_kernel<T, D, kOut><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), h, hkv, page, m, scale, softcap);
  return (int)cudaGetLastError();
}

// The instantiation with the fewest outputs per thread that covers G * D.
template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* lens, void* out, int b, int h, int hkv, int page, int m,
           float scale, float softcap, cudaStream_t stream) {
  const int width = (h / hkv) * D;
#define PA_OUT(N)                                                                       \
  if (width <= (N) * kThreads)                                                          \
    return launch_out<T, D, N>(q, kp, vp, tables, lens, out, b, h, hkv, page, m, scale, \
                               softcap, stream)
  PA_OUT(8);
  PA_OUT(16);
  PA_OUT(kMaxOut);
#undef PA_OUT
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ bf16 kernels
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = attn_tile::kWarps;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRoundKeys = attn_tile::kTileKeys;  // keys per round (and split unit)
constexpr int kTcStages = 2;                       // rounds in the ring
constexpr int kMaxTcGroup = 16 * kTcWarps;        // query heads per KV head

// 16-row groups of q a block stages: G = h / hkv rows.
__host__ __device__ inline int q_groups(int g) { return (g + 15) / 16; }

// Shared memory: the K ring [kTcStages][kRoundKeys][D + pad] and the V
// ring (after the key loop: the split warps' partial (m, l, O)), the q rows
// [16 * groups][D + pad] and the table row [m].
template <int D>
__host__ __device__ inline size_t tc_smem_bytes(int groups, int m) {
  return (size_t)(2 * kTcStages * kRoundKeys + 16 * groups) * attn_tile::row_stride<D>() *
             sizeof(bf16) +
         (size_t)m * sizeof(int);
}

// Block (kvh, b, sp) attends the G query heads of sequence b that read KV
// head kvh over keys [sp * split_keys, min(seq_len, (sp + 1) * split_keys)).
// One split (gridDim.z == 1): it writes out.  More: it writes its rows'
// unnormalised O to part_o (nsplit, b_count, h, D) and (m, l) -- m in log2
// units -- to part_ml (nsplit, b_count, h, 2), l = 0 for a split with no key.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, bf16* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int b_count,
                    int h, int hkv, int page, int m, int split_keys, float scale,
                    float softcap) {
  using Tile = attn_tile::WarpTile<D>;
  constexpr int S = attn_tile::row_stride<D>();
  constexpr int kRowChunks = D / 8;  // 16-byte chunks per row
  static_assert((kRoundKeys * 2 * kTcStages * S * sizeof(bf16)) >=
                    (kTcWarps - 1) * 16 * Tile::kPartStride * sizeof(float),
                "the split warps' partials must fit in the K/V rings");
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int nsplit = gridDim.z;
  const int grp = h / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)b * h + (size_t)kvh * grp;  // the block's first (b, head) row
  const size_t part0 = (size_t)sp * b_count * h + row0;   // and its first partial row

  const attn_tile::WarpRole role(grp, warp);
  const int groups = q_groups(grp);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTcStages * kRoundKeys * S;
  bf16* q_s = v_s + kTcStages * kRoundKeys * S;
  int* tbl_s = reinterpret_cast<int*>(q_s + 16 * groups * S);

  // The table entries of the split's pages, by page index, are requested
  // beside seq_len (they do not depend on it), so the two loads overlap;
  // then whether any entry inside the context is -1 (the engine never
  // builds one).
  const int k_begin = sp * split_keys;
  const int seq_len = seq_lens[b];
  const int p0 = k_begin / page;
  const int pe = min(m, (k_begin + split_keys + page - 1) / page);
  const int k_end = min(min(seq_len, m * page), k_begin + split_keys);
  const int p1 = (k_end + page - 1) / page;
  int hole = 0;
  for (int i = p0 + tid; i < pe; i += kTcThreads) {
    const int blk = tables[(size_t)b * m + i];
    tbl_s[i] = blk;
    hole |= blk < 0 && i < p1;
  }
  if (k_end <= k_begin) {  // no key: rows of 0, or an empty split
    if (nsplit == 1) {
      uint4* o = reinterpret_cast<uint4*>(out + row0 * D);
      for (int e = tid; e < grp * kRowChunks; e += kTcThreads) o[e] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int r = tid; r < grp; r += kTcThreads)
        reinterpret_cast<float2*>(part_ml)[part0 + r] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  // Every row of the block keeps the keys [k_begin, k_end).
  Tile w;
  {
    const int lo[2] = {k_begin, k_begin}, hi[2] = {k_end, k_end};
    bool exists[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      exists[i] = role.active && 16 * role.rw + (lane >> 2) + 8 * i < grp;
    w.set_rows(lo, hi, exists);
  }

  // The G q rows (rows past G are zero); these copies join the first
  // round's group.
  for (int e = tid; e < 16 * groups * kRowChunks; e += kTcThreads) {
    const int r = e / kRowChunks, c = e - r * kRowChunks;
    bf16* dst = q_s + r * S + c * 8;
    if (r < grp)
      attn_tile::cp_async16(dst, q + (row0 + r) * D + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  hole = __syncthreads_or(hole);

  const int pshift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  const size_t tok_stride = (size_t)hkv * D;  // elements between a page's tokens
  const bf16* kb = k_pool + (size_t)kvh * D;
  const bf16* vb = v_pool + (size_t)kvh * D;
  const int nrounds = (k_end - k_begin + kRoundKeys - 1) / kRoundKeys;

  // Every 16-byte copy of round rd's K and V rows into its stage, then one
  // commit (an empty group past the last round): thread tid copies chunk c8
  // of every kRowsPerPass-th row, K and V of a key from one offset.  A key
  // on a -1 entry is read from page 0 (its scores are masked below, so its
  // rows only ever meet p = 0), and V rows past k_end up to the next 16-key
  // chunk are zeroed: P V multiplies them by p = 0.
  constexpr int kRowsPerPass = kTcThreads / kRowChunks;
  const int c8 = (tid % kRowChunks) * 8;
  auto fetch = [&](int rd) {
    if (rd < nrounds) {
      const int k0 = k_begin + rd * kRoundKeys;
      const int n = min(kRoundKeys, k_end - k0);
      const int st = rd % kTcStages;
      bf16* ks = k_s + st * kRoundKeys * S;
      bf16* vs = v_s + st * kRoundKeys * S;
      for (int r = tid / kRowChunks; r < n; r += kRowsPerPass) {
        const int t = k0 + r;
        const int pi = pshift >= 0 ? t >> pshift : t / page;
        const size_t off =
            ((size_t)max(tbl_s[pi], 0) * page + (t - pi * page)) * tok_stride + c8;
        attn_tile::cp_async16(ks + r * S + c8, kb + off);
        attn_tile::cp_async16(vs + r * S + c8, vb + off);
      }
      for (int r = n + tid / kRowChunks; r < ((n + 15) & ~15); r += kRowsPerPass)
        *reinterpret_cast<uint4*>(vs + r * S + c8) = make_uint4(0u, 0u, 0u, 0u);
    }
    attn_tile::cp_async_commit();
  };
  // The page of key t.
  auto page_of = [&](int t) { return pshift >= 0 ? t >> pshift : t / page; };

  for (int rd = 0; rd < kTcStages - 1; ++rd) fetch(rd);
  for (int rd = 0; rd < nrounds; ++rd) {
    fetch(rd + kTcStages - 1);
    attn_tile::cp_async_wait<kTcStages - 1>();  // this thread's copies of round rd (and q)
    __syncthreads();                             // ...everyone's
    if (rd == 0 && role.active) w.load_q(q_s + 16 * role.rw * S, S);
    const int k0 = k_begin + rd * kRoundKeys;
    const int st = rd % kTcStages;
    // The round's kept keys as runs [a, b) between -1 entries: one run,
    // the whole round, unless the split has a -1 entry.  A run narrows the
    // rows' kept keys (every row of a decode block keeps the same ones), so
    // the tile masks the keys outside it.
    const int stop = min(k0 + kRoundKeys, k_end);
    int a = k0;
    do {
      int b = stop;
      if (hole) {
        while (a < stop && tbl_s[page_of(a)] < 0) a = (page_of(a) + 1) * page;
        b = a;
        while (b < stop && tbl_s[page_of(b)] >= 0) b = min(stop, (page_of(b) + 1) * page);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (w.lo[i] != attn_tile::kNoKey) {
            w.lo[i] = a;
            w.hi[i] = b;
          }
        }
        if (w.lo_min != attn_tile::kNoKey) {
          w.lo_min = w.lo_max = a;
          w.hi_min = w.hi_max = b;
        }
      }
      int c0 = role.c0, c1 = role.c1;
      w.live_chunks(k0, c0, c1);
      if (role.active && a < b && c0 < c1) {
        const bool edge = !(k0 + 16 * c0 >= w.lo_max && k0 + 16 * c1 <= w.hi_min);
        w.tile(k_s + st * kRoundKeys * S, v_s + st * kRoundKeys * S, S, k0, c0, c1, edge, scale,
               softcap);
      }
      a = b;
    } while (hole && a < stop);
    __syncthreads();  // stage st is free for round rd + kTcStages
  }
  attn_tile::cp_async_wait<0>();  // no copy outlives the block
  attn_tile::merge_splits(w, role, reinterpret_cast<float*>(k_s));
  if (!role.active || role.sp != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * role.rw + (lane >> 2) + 8 * i;
    if (r >= grp) continue;
    if (nsplit == 1) {
      w.store_row(i, out + (row0 + r) * D);
      continue;
    }
    float* po = part_o + (part0 + r) * D;
#pragma unroll
    for (int n = 0; n < Tile::kN; ++n)
      *reinterpret_cast<float2*>(po + 8 * n + 2 * (lane & 3)) =
          make_float2(w.o[n][2 * i], w.o[n][2 * i + 1]);
    if ((lane & 3) == 0)
      reinterpret_cast<float2*>(part_ml)[part0 + r] = make_float2(w.m[i], w.l[i]);
  }
}

template <int D>
int launch_tc(const void* q, const void* kp, const void* vp, const void* tables,
              const void* lens, void* out, void* part_o, void* part_ml, int b, int h,
              int hkv, int page, int m, int nsplit, int split_keys, float scale,
              float softcap, cudaStream_t stream) {
  const int g = h / hkv;
  if (g > kMaxTcGroup || nsplit < 1 || split_keys < kRoundKeys || split_keys % kRoundKeys ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<D>(q_groups(g), m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, b, nsplit);
  paged_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), b, h, hkv, page, m,
      split_keys, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  return split_merge::launch_merge<D>(static_cast<const float*>(part_o),
                                      static_cast<const float*>(part_ml),
                                      static_cast<bf16*>(out), b * h, nsplit, stream);
}

}  // namespace

// dtype: 0 = float32 (decode_kernel), 1 = bfloat16 (paged_tc_kernel, then
// merge_kernel when nsplit > 1); d = 64, 128 or 256, and at fp32
// (h / hkv) * d <= 4096.  q (b, h, d), pools (n, page, hkv, d),
// tables (b, m) int32, seq_lens (b,) int32, out (b, h, d); the pools (and
// bf16 q) 16-byte aligned (the wrapper checks).  bf16 only: the keys are cut into
// nsplit splits of split_keys (a multiple of 64) and, when nsplit > 1,
// part_o (nsplit, b, h, d) and part_ml (nsplit, b, h, 2) are fp32
// workspaces.  Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for an unsupported head dim, dtype,
// group width or split.  Launches on `stream`, allocates nothing, never
// synchronises.
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* tables,
                               const void* seq_lens, void* out, void* part_o,
                               void* part_ml, int b, int h, int hkv, int d, int page,
                               int m, int nsplit, int split_keys, float scale,
                               float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(DIM)                                                              \
  return launch<float, DIM>(q, k_pool, v_pool, tables, seq_lens, out, b, h, hkv, \
                            page, m, scale, softcap, st)
  if (dtype == 0 && d == 64) PA_LAUNCH(64);
  if (dtype == 0 && d == 128) PA_LAUNCH(128);
  if (dtype == 0 && d == 256) PA_LAUNCH(256);
#undef PA_LAUNCH
#define PA_LAUNCH_TC(DIM)                                                           \
  return launch_tc<DIM>(q, k_pool, v_pool, tables, seq_lens, out, part_o, part_ml, \
                        b, h, hkv, page, m, nsplit, split_keys, scale, softcap, st)
  if (dtype == 1 && d == 64) PA_LAUNCH_TC(64);
  if (dtype == 1 && d == 128) PA_LAUNCH_TC(128);
  if (dtype == 1 && d == 256) PA_LAUNCH_TC(256);
#undef PA_LAUNCH_TC
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel that `dtype` and `d`
// launch -- decode_kernel (dtype 0) or paged_tc_kernel (dtype 1) -- for g
// query heads per KV head, `page` tokens per page and a table width of m,
// in bytes (0 for an unsupported head dim or dtype).
extern "C" long long paged_attention_smem_bytes(int dtype, int d, int g, int page, int m) {
  if (dtype == 0 && d == 64) return (long long)smem_bytes<float, 64>(g, page);
  if (dtype == 0 && d == 128) return (long long)smem_bytes<float, 128>(g, page);
  if (dtype == 0 && d == 256) return (long long)smem_bytes<float, 256>(g, page);
  if (dtype == 1 && d == 64) return (long long)tc_smem_bytes<64>(q_groups(g), m);
  if (dtype == 1 && d == 128) return (long long)tc_smem_bytes<128>(q_groups(g), m);
  if (dtype == 1 && d == 256) return (long long)tc_smem_bytes<256>(q_groups(g), m);
  return 0;
}
