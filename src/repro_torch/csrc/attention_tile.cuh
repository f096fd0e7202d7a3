// The bf16 tensor-core attention tile of the decode kernel,
// paged_attention.cu (the Hopper kernels of wg_attention.cuh take only its
// quad and warp reductions and bf16 packing): device functions only, no
// kernel and no C interface.
//
// One warp owns 16 query rows.  At D <= 128 its q rows stay in registers
// as the A-fragments of mma.sync.m16n8k16 (bf16 inputs, fp32 accumulation);
// at D = 256 they are read from the block's shared q rows, one 16-deep
// chunk at a time (WarpTile::kQShared below).  For
// each shared K/V tile of kTileKeys keys it computes S = Q K^T into fp32
// registers, applies the scale and the optional softcap there, runs the
// online softmax on the registers, packs P to bf16 A-fragments straight
// from the S registers and accumulates O += P V in fp32 registers.
//
// Accumulator layout (PTX ISA, mma.m16n8k16 with .f32 accumulators): lane
// L holds rows L/4 and L/4 + 8 of the 16, at columns 2 (L % 4) + {0, 1} of
// each 8-wide column tile.  So the 4 lanes of a quad share a row, and a
// row's max and sum are reduced over the quad with two __shfl_xor_sync.
//
// Shared K, V and q rows are D bf16 plus a 16-byte pad (kRowPad): the 8
// rows that one ldmatrix phase reads then start 16 bytes apart modulo 128,
// on 8 different bank groups, so ldmatrix has no bank conflicts at D = 64,
// 128 or 256; at D = 80 (rows of 176 bytes) they start 48 bytes apart
// modulo 128, on 8 different groups again.
//
// The one rounding this adds to the plain version's arithmetic is P to
// bf16 before P V (l sums the fp32 probabilities); scores, the softmax and
// every sum stay fp32.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kTileKeys = 64;               // keys per shared K/V tile
constexpr int kChunks = kTileKeys / 16;     // 16-key chunks per tile
constexpr int kRowPad = 8;                  // bf16 elements past each shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNoKey = 1 << 30;             // [lo, hi) of a row that does not exist

// Elements between two shared q, K or V rows of head dim D.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + kRowPad;
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
// (as a shared-window address, or as a pointer).
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_at(r, smem_u32(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp's 16 query rows.  Row i (0: lane / 4, 1: lane / 4 + 8) keeps the
// keys in [lo[i], hi[i]); a row that does not exist has lo = kNoKey and
// hi = -kNoKey, keeps nothing and takes no part in the warp's key range.
//
// Registers: O takes D / 2 fp32 registers per lane and a 64-key tile's
// scores 32 more.  Keeping q's D / 4 fragment registers beside them fits at
// D <= 128 but not at D = 256 (64 + 128 + 32 before any address or loop
// state, against 255), so there kQShared keeps only the shared address of
// the lane's q row and each tile reads the 16 q fragments again with
// ldmatrix (16 per 64-key tile, beside the tile's 64 for K and 64 for V).
// Every kernel that uses the tile keeps its q rows in shared memory for the
// whole key loop.
template <int D>
struct WarpTile {
  static constexpr int kK = D / 16;  // 16-deep chunks of a q row
  static constexpr int kN = D / 8;   // 8-wide column tiles of O
  static constexpr bool kQShared = D > 128;
  uint32_t q[kQShared ? 1 : kK][4];  // A-fragments of the 16 q rows (D <= 128)
  unsigned q_addr;                   // this lane's shared q address (D > 128)
  float o[kN][4];                    // O accumulators
  float m[2];                        // running max of log2-scaled scores
  float l[2];                        // this lane's part of the running sum
  int lo[2], hi[2];                  // kept keys of the two rows
  int lo_min, lo_max, hi_min, hi_max;  // over the warp's rows that exist

  // Sets the rows' key ranges and the warp's bounds over them.  Every lane
  // of the warp calls this.
  __device__ __forceinline__ void set_rows(const int (&lo_)[2], const int (&hi_)[2],
                                           const bool (&exists)[2]) {
    int a = kNoKey, b = -kNoKey, c = kNoKey, d = -kNoKey;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lo[i] = exists[i] ? lo_[i] : kNoKey;
      hi[i] = exists[i] ? hi_[i] : -kNoKey;
      if (exists[i]) {
        a = min(a, lo_[i]);
        b = max(b, lo_[i]);
        c = min(c, hi_[i]);
        d = max(d, hi_[i]);
      }
    }
    lo_min = warp_min(a);
    lo_max = warp_max(b);
    hi_min = warp_min(c);
    hi_max = warp_max(d);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
  }

  // q rows 0..15 of this warp from shared rows of `stride` elements (at
  // D > 128 only their address: the rows must stay there).
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q_s, int stride) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* p = q_s + (lane & 15) * stride + (lane >> 4) * 8;
    if constexpr (kQShared) {
      q_addr = smem_u32(p);
    } else {
#pragma unroll
      for (int kc = 0; kc < kK; ++kc) ldmatrix_x4(q[kc], p + 16 * kc);
    }
  }

  // Narrows [c0, c1), this warp's 16-key chunks of the tile whose first key
  // is k0, to those that some row of the warp keeps; empty when c0 >= c1.
  __device__ __forceinline__ void live_chunks(int k0, int& c0, int& c1) const {
    if (lo_min > k0) c0 = max(c0, min(kChunks, (lo_min - k0) / 16));
    c1 = hi_max <= k0 ? 0 : min(c1, (hi_max - k0 + 15) / 16);
  }

  // One K/V tile: keys k0 + 16 c0 .. k0 + 16 c1 - 1 of shared rows k_s, v_s.
  // `edge` says that some row keeps only part of those keys; otherwise no
  // mask is computed.  scale = D^-0.5, cap = the softcap (0: none); scores
  // are kept times log2(e), so the softmax runs on exp2.
  __device__ __forceinline__ void tile(const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
                                       int stride, int k0, int c0, int c1, bool edge,
                                       float scale, float cap) {
    const int lane = threadIdx.x & 31;
    float s[2 * kChunks][4];
#pragma unroll
    for (int j = 0; j < 2 * kChunks; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // S = Q K^T: one ldmatrix.x4 gives the B-fragments of two 8-key tiles
    const __nv_bfloat16* kp =
        k_s + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 8;
    if constexpr (kQShared) {
      // one 16-deep chunk of q at a time, read once for all the tile's keys
#pragma unroll
      for (int kc = 0; kc < kK; ++kc) {
        uint32_t qa[4];
        ldmatrix_x4_at(qa, q_addr + 32u * kc);  // 16 bf16 further along the row
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c < c0 || c >= c1) continue;
          uint32_t b[4];
          ldmatrix_x4(b, kp + 16 * c * stride + 16 * kc);
          mma_bf16(s[2 * c], qa, b[0], b[1]);
          mma_bf16(s[2 * c + 1], qa, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (c < c0 || c >= c1) continue;
#pragma unroll
        for (int kc = 0; kc < kK; ++kc) {
          uint32_t b[4];
          ldmatrix_x4(b, kp + 16 * c * stride + 16 * kc);
          mma_bf16(s[2 * c], q[kc], b[0], b[1]);
          mma_bf16(s[2 * c + 1], q[kc], b[2], b[3]);
        }
      }
    }

    // scale, softcap and mask in registers; the tile's row max
    const float qk_scale = scale * kLog2e;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < c0 || c >= c1) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * c + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float z = s[j][e];
          z = cap != 0.f ? tanhf(z * scale / cap) * (cap * kLog2e) : z * qk_scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
            if (key < lo[i] || key >= hi[i]) z = -INFINITY;
          }
          s[j][e] = z;
          mx[i] = fmaxf(mx[i], z);
        }
      }
    }

    // online softmax: masked scores (-inf) enter neither max nor sum
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no kept key yet: exp2(-inf) = 0
      const float alpha = exp2f(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < c0 || c >= c1) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[2 * c + jj][e] - mu[e >> 1]);
          s[2 * c + jj][e] = p;
          l[e >> 1] += p;
        }
    }

    // O += P V: P's A-fragment of a 16-key chunk is the S registers of its
    // two 8-key tiles; one ldmatrix.x4.trans gives V's B-fragments of two
    // 8-column tiles
    const __nv_bfloat16* vp =
        v_s + ((lane & 7) + (((lane >> 3) & 1) << 3)) * stride + (lane >> 4) * 8;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c < c0 || c >= c1) continue;
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dd = 0; dd < kK; ++dd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vp + 16 * c * stride + 16 * dd);
        mma_bf16(o[2 * dd], a, b[0], b[1]);
        mma_bf16(o[2 * dd + 1], a, b[2], b[3]);
      }
    }
  }

  // Finishes l: the quad's parts summed (call once, after the last tile).
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  }

  // A warp that ran other keys of the same 16 rows hands over its (m, l, O)
  // through shared memory: 16 fp32 rows of D + 2 (O, then m and l).  Both
  // sides call reduce_l() first.
  static constexpr int kPartStride = D + 2;

  __device__ __forceinline__ void save_partial(float* part) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = part + ((lane >> 2) + 8 * i) * kPartStride;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * (lane & 3)) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if ((lane & 3) == 0) {
        row[D] = m[i];
        row[D + 1] = l[i];
      }
    }
  }

  __device__ __forceinline__ void merge_partial(const float* part) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* row = part + ((lane >> 2) + 8 * i) * kPartStride;
      const float m2 = row[D], l2 = row[D + 1];
      const float m_new = fmaxf(m[i], m2);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float a1 = exp2f(m[i] - mu), a2 = exp2f(m2 - mu);
      m[i] = m_new;
      l[i] = l[i] * a1 + l2 * a2;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(row + 8 * n + 2 * (lane & 3));
        o[n][2 * i] = o[n][2 * i] * a1 + x.x * a2;
        o[n][2 * i + 1] = o[n][2 * i + 1] * a1 + x.y * a2;
      }
    }
  }

  // Row i's output, O / l with a safe l (a row that keeps no key: 0), as
  // bf16 into the row's D contiguous elements.
  __device__ __forceinline__ void store_row(int i, __nv_bfloat16* row) const {
    const int lane = threadIdx.x & 31;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * (lane & 3)) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
};

// How a block's kWarps warps share a tile of up to 16 * kWarps query rows:
// nr warps of 16 rows each, and when the rows need fewer than kWarps warps,
// the warps that share rows split every K/V tile's 16-key chunks (16 rows:
// 4 ways, 32 rows: 2 ways) and merge their (m, l, O) at the end.  With 48
// rows the fourth warp only copies.
constexpr int kWarps = 4;

struct WarpRole {
  int nr, splits;  // warps of rows, ways each K/V tile is split (block-uniform)
  int rw, sp;      // this warp's 16 rows and its part of the keys
  int c0, c1;      // its 16-key chunks [c0, c1) of every tile
  bool active;     // false: only copies

  __device__ __forceinline__ WarpRole(int rows, int warp) {
    nr = max(1, min(kWarps, (rows + 15) / 16));
    splits = nr == 1 ? 4 : nr == 2 ? 2 : 1;
    rw = warp % nr;
    sp = warp / nr;
    active = sp < splits;
    c0 = sp * kChunks / splits;
    c1 = (sp + 1) * kChunks / splits;
  }
};

// After the key loop: the split warps hand their (m, l, O) to the warp of
// sp = 0 through `part` (shared memory the K/V rings no longer need, at
// least (kWarps - 1) * 16 * kPartStride floats).  Every thread of the block
// calls this; afterwards the warps with active and sp == 0 hold the rows.
template <int D>
__device__ __forceinline__ void merge_splits(WarpTile<D>& w, const WarpRole& role,
                                             float* part) {
  w.reduce_l();
  if (role.splits == 1) return;
  constexpr int kPart = 16 * WarpTile<D>::kPartStride;
  __syncthreads();  // every warp is past the rings
  if (role.active && role.sp > 0) w.save_partial(part + ((role.sp - 1) * role.nr + role.rw) * kPart);
  __syncthreads();
  if (role.active && role.sp == 0)
    for (int s2 = 1; s2 < role.splits; ++s2)
      w.merge_partial(part + ((s2 - 1) * role.nr + role.rw) * kPart);
}

}  // namespace attn_tile
