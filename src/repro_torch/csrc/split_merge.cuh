// The log-sum-exp merge of split-KV partials, shared by the bf16 decode
// kernel (paged_attention.cu) and the bf16 ragged kernel
// (ragged_paged_attention.cu): a kernel template only, no C interface.
//
// Each of `nsplit` splits of a row's keys leaves its unnormalised fp32
// output O_s, its running max m_s (log2 units: scores times log2(e)) and its
// sum l_s = sum 2^(score - m_s); a split whose keys the row keeps none of
// leaves l_s = 0 and need not write O_s.  Layout: part_o (nsplit, rows, D),
// part_ml (nsplit, rows, 2) as (m, l) pairs, out (rows, D) bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace split_merge {

constexpr int kMergeThreads = 128;

// Combines the nsplit partials of each of `rows` rows:
// out = sum_s O_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M the largest m_s of
// the splits with l_s > 0; a split with l_s = 0 is skipped (its O_s was
// never written), a row with no such split is 0.  D / 4 threads per row,
// 4 outputs each.
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                 __nv_bfloat16* __restrict__ out, int rows, int nsplit) {
  constexpr int kLanes = D / 4;
  constexpr int kRowsPerBlock = kMergeThreads / kLanes;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int c = (threadIdx.x % kLanes) * 4;
  if (r >= rows) return;
  const float2* ml = reinterpret_cast<const float2*>(part_ml);
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) {
    const float2 x = ml[(size_t)s * rows + r];
    if (x.y > 0.f) mx = fmaxf(mx, x.x);
  }
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const float2 x = ml[(size_t)s * rows + r];
    if (!(x.y > 0.f)) continue;
    const float a = exp2f(x.x - mx);
    const float4 o = *reinterpret_cast<const float4*>(part_o + ((size_t)s * rows + r) * D + c);
    l += x.y * a;
    acc.x += a * o.x;
    acc.y += a * o.y;
    acc.z += a * o.z;
    acc.w += a * o.w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  *reinterpret_cast<uint2*>(out + (size_t)r * D + c) =
      make_uint2(attn_tile::pack_bf16(acc.x * inv, acc.y * inv),
                 attn_tile::pack_bf16(acc.z * inv, acc.w * inv));
}

// Launches merge_kernel<D> over `rows` rows on `stream`; returns
// cudaGetLastError().
template <int D>
int launch_merge(const float* part_o, const float* part_ml, __nv_bfloat16* out, int rows,
                 int nsplit, cudaStream_t stream) {
  const int per_block = kMergeThreads / (D / 4);
  merge_kernel<D><<<(rows + per_block - 1) / per_block, kMergeThreads, 0, stream>>>(
      part_o, part_ml, out, rows, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace split_merge
