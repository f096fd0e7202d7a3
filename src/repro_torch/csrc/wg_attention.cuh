// The warpgroup attention tile shared by the bf16 Hopper kernels
// flash_wg_kernel (flash_attention.cu) and ragged_wg_kernel
// (ragged_paged_attention.cu): a consumer warpgroup's 64 query rows against
// one K/V tile of kN keys, S = Q K^T by wgmma from shared memory into fp32
// registers, the scale, softcap, masks and online softmax there (log2
// units), P rounded to bf16 in registers as the A operand of O += P V, V
// read as it lies through the descriptor's transpose.  Plus the host side
// both kernels need: tensor maps encoded by cuTensorMapEncodeTiled,
// and the dynamic shared-memory attribute set once per device.  No kernel
// and no C interface.
//
// Operand layouts (csrc/hopper.cuh): q and K are K-major in swizzled atom
// columns of W bf16 columns (W = 64: 128-byte rows and swizzle; W = 16 at
// D = 80: 32-byte rows and swizzle), q's atom column kQRows rows long, a K
// or V tile's kN rows long; every tile on a 1024-byte boundary.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <utility>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace wg {

// The swizzle atoms of a head dim D: bf16 columns per atom (kW), bytes of an
// atom row (kSpan), the descriptors' layout type and atoms per row.
template <int D>
struct Atom {
  static constexpr int kW = D % 64 == 0 ? 64 : 16;
  static constexpr int kSpan = 2 * kW;
  static constexpr int kLayout = kW == 64 ? hopper::kSwizzle128B : hopper::kSwizzle32B;
  static constexpr int kAtoms = D / kW;
};

// Scores of one K/V tile in a consumer's registers (element 4 j + e: row
// e / 2 of the thread's two, key k0 + 8 j + 2 (lane % 4) + e % 2), made
// ready for the online softmax: with a softcap, tanh(s * scale / cap) * cap
// times log2(e); without, left raw (the softmax scales them in its exp2).
// Masked keys become -inf (only on a tile some row keeps in part: kEdge).
// Returns each row's max, in the log2-scaled units.
template <int kN, bool kCap, bool kEdge>
__device__ __forceinline__ void tile_scores(float (&sc)[kN / 2], float (&mx)[2], int k0,
                                            int lane, const int (&lo)[2], const int (&hi)[2],
                                            float qk_scale, float cap_in, float cap_out) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float z = sc[4 * j + e];
      if (kCap) z = tanhf(z * cap_in) * cap_out;
      if (kEdge) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        if (key < lo[r] || key >= hi[r]) z = -INFINITY;
      }
      sc[4 * j + e] = z;
      mx[r] = fmaxf(mx[r], z);
    }
  if (!kCap) {
    mx[0] *= qk_scale;  // qk_scale > 0 keeps the order, and -inf
    mx[1] *= qk_scale;
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one tile into a consumer's registers: D / 16 steps of 16,
// q and K both K-major in their swizzled atom columns (step kk reads atom
// column 16 kk / W at byte 2 (16 kk % W) of its rows; q's atom columns are
// kQRows rows long, K's kN).
template <int D, int kN, int kQRows, int... kk>
__device__ __forceinline__ void qk_steps(float (&sc)[kN / 2], uint64_t dq, uint64_t dk,
                                         std::integer_sequence<int, kk...>) {
  using C = Atom<D>;
  constexpr int kW = C::kW, kSpan = C::kSpan;
  (hopper::SS<kN>::template mma<(16 * kk / kW * kQRows * kSpan + 32 * kk % (2 * kW)) / 16,
                                (16 * kk / kW * kN * kSpan + 32 * kk % (2 * kW)) / 16>(
       sc, dq, dk, kk > 0),
   ...);
}

template <int D, int kN, int kQRows>
__device__ __forceinline__ void qk_product(float (&sc)[kN / 2], uint32_t q_wg, uint32_t ks) {
  using C = Atom<D>;
  qk_steps<D, kN, kQRows>(sc, hopper::desc(q_wg, 16, 8 * C::kSpan, C::kLayout),
                          hopper::desc(ks, 16, 8 * C::kSpan, C::kLayout),
                          std::make_integer_sequence<int, D / 16>());
}

// O += P V of one tile: P from registers, V as it lies (keys x D), read
// transposed by its descriptor, 16 keys (16 rows of every atom column) a step.
template <int D, int kN, int... c>
__device__ __forceinline__ void pv_steps(float (&o)[D / 2], const uint32_t (&p)[kN / 16][4],
                                         uint64_t dv, std::integer_sequence<int, c...>) {
  (hopper::RS<D>::template mma<c * Atom<D>::kSpan>(o, p[c], dv), ...);
}

template <int D, int kN>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&p)[kN / 16][4],
                                           uint32_t vs) {
  using C = Atom<D>;
  pv_steps<D, kN>(o, p, hopper::desc(vs, kN * C::kSpan, 8 * C::kSpan, C::kLayout),
                  std::make_integer_sequence<int, kN / 16>());
}

// The online softmax of one tile's scores: the running max m (log2 units),
// alpha = 2^(m_old - m_new) for O and l, and the tile's probabilities
// 2^(score - m_new), fp32, in place of the scores; l gains their sum.
// Two forms of the same arithmetic, each the faster for one kernel on the
// H100 (PERF.md §6, runs AB1, AB2, Z4, Z5).  The default folds the
// softcap into four copies of the score loop: the flash kernel's long
// calls run 1-4 % slower with the other.  kCapApart applies the softcap
// in a loop of its own ahead of two copies: the ragged kernel's short
// serving calls, run between a layer's GEMMs, take 0.343 ms per Llama
// decode step of 32 launches with it and 0.437 with the default.
template <int kN, bool kCapApart = false>
__device__ __forceinline__ void softmax_tile(float (&sc)[kN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int lane,
                                             const int (&lo)[2], const int (&hi)[2],
                                             int lo_max, int hi_min, float qk_scale,
                                             float softcap, float cap_in, float cap_out) {
  const bool edge = k0 < lo_max || k0 + kN > hi_min;  // some row keeps part of the tile
  float mx[2];
  if (kCapApart) {
    if (softcap != 0.f) {
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) sc[j] = tanhf(sc[j] * cap_in) * cap_out;
    }
    // capped scores are in log2 units already: their max takes no factor
    const float mscale = softcap != 0.f ? 1.f : qk_scale;
    if (edge)
      tile_scores<kN, false, true>(sc, mx, k0, lane, lo, hi, mscale, cap_in, cap_out);
    else
      tile_scores<kN, false, false>(sc, mx, k0, lane, lo, hi, mscale, cap_in, cap_out);
  } else if (softcap != 0.f) {
    if (edge)
      tile_scores<kN, true, true>(sc, mx, k0, lane, lo, hi, qk_scale, cap_in, cap_out);
    else
      tile_scores<kN, true, false>(sc, mx, k0, lane, lo, hi, qk_scale, cap_in, cap_out);
  } else {
    if (edge)
      tile_scores<kN, false, true>(sc, mx, k0, lane, lo, hi, qk_scale, cap_in, cap_out);
    else
      tile_scores<kN, false, false>(sc, mx, k0, lane, lo, hi, qk_scale, cap_in, cap_out);
  }
  const float f = softcap != 0.f ? 1.f : qk_scale;  // the scores' factor into log2 units
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], attn_tile::quad_max(mx[r]));
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no kept key yet: 2^-inf = 0
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(sc[4 * j + e], f, -mu[e >> 1]));
      sc[4 * j + e] = x;
      l[e >> 1] += x;
    }
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P to bf16 straight from the S registers: keys 16 c .. 16 c + 15 of the
// tile are registers 8 c .. 8 c + 7, i.e. the A operand of one 16-deep step.
template <int kN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kN / 16][4], const float (&sc)[kN / 2]) {
#pragma unroll
  for (int c = 0; c < kN / 16; ++c)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[c][x] = attn_tile::pack_bf16(sc[8 * c + 2 * x], sc[8 * c + 2 * x + 1]);
}

// ---------------------------------------------------------------- host side
// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query: the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, T, H, D) bf16 tensor whose (T, H, D) part is contiguous, batch
// stride `bstride` elements, as the 4-d map {D, H, T, B} (innermost first)
// read in boxes of {w, heads, rows, 1}.  Rows past T read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int b, int t, int h, int d,
                       long long bstride, int w, int heads, int rows,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  t = t > 0 ? t : 1;  // a map needs extents of at least 1; no tile reads past Tk
  const long long tok = (long long)h * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)tok * 2,
                                 (cuuint64_t)(b > 1 ? bstride : t * tok) * 2};
  const cuuint32_t box[4] = {(cuuint32_t)w, (cuuint32_t)heads, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Opts `kernel` into `bytes` of dynamic shared memory on the calling
// thread's current device.  The attribute belongs to the device's context,
// so it is set once per device, never once per process: `devices` (one per
// kernel, static at its launch site) holds a bit per device index that has
// it; past index 63 it is set at every call.  Returns 0 or the CUDA error.
inline int smem_attribute(std::atomic<unsigned long long>& devices, const void* kernel,
                          int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (devices.load(std::memory_order_acquire) & bit)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  devices.fetch_or(bit, std::memory_order_release);
  return 0;
}

}  // namespace wg
