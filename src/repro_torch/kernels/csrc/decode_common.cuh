// Shared pieces of the two flash-decode GQA kernels (gqa_decode.cu,
// paged_decode.cu): element conversion, vector loads, the tiled
// online-softmax sweep of one warp, the in-block merge of the warps'
// partial states, and the pass that merges the splits of S.
//
// Work split. One thread block handles one (row, kv_head, split of S)
// with WARPS warps; the block stages the QPK query heads of its kv group
// in shared memory. Each warp walks the split in tiles of 32 tokens, one
// token per lane:
//   1. scores: each lane reads its token's K head row (16-byte loads;
//      the 32 lanes have 32 independent loads in flight) and dots it with
//      the staged queries, QPK heads at once;
//   2. softmax: one warp max and one warp sum per head per tile (not per
//      token) update the f32 running (m, l), replicated on all lanes;
//   3. P.V: the tile's valid tokens' V rows are read coalesced (lane =
//      HD/32 dims) and accumulated into acc, which each lane keeps for
//      its dims of every head.
// QPK <= 8 query rows is far under any MMA tile, so the dots are plain
// FMAs. Masked tokens (and whole masked tiles) are never loaded. The
// warps merge in shared memory, each block writes one partial (m, l,
// acc) per query head, and combine_kernel merges the splits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;            // tokens per warp tile (one per lane)
constexpr float NEG_INF = -1e30f;   // the Pallas kernels' mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  const Vec<T, N> r = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(r.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// Per-warp running softmax state: m/l per query head (the same on every
// lane), acc per head for the lane's VEC = HD/32 dims.
template <int HD, int QPK>
struct WarpState {
  static constexpr int VEC = HD / 32;
  float m[QPK];
  float l[QPK];
  float acc[QPK][VEC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[h][i] = 0.f;
    }
  }
};

// Shared memory of one block.
template <int HD, int QPK>
struct Smem {
  alignas(16) float q[QPK][HD];             // staged queries, f32
  float p[WARPS][QPK][TILE];                // a tile's softmax weights
  float m[WARPS][QPK];                      // warp partials for the merge
  float l[WARPS][QPK];
  float acc[WARPS][QPK][HD];
};

// Stage the QPK query heads of kv group g of `row` into shared memory.
template <typename T, int HD, int QPK>
__device__ __forceinline__ void stage_q(Smem<HD, QPK>& sm, const T* q,
                                        int row, int H, int g) {
  const T* src = q + ((int64_t)row * H + g * QPK) * HD;
  for (int i = threadIdx.x; i < QPK * HD; i += THREADS)
    sm.q[i / HD][i % HD] = to_f(src[i]);
  __syncthreads();
}

// One warp's sweep over tokens [t_begin, t_end) of one row, in tiles of
// 32. `offset(t)` is the element offset of token t's K (= V) head row;
// `valid(t)` says whether token t (< t_end) is attended.
template <typename T, int HD, int QPK, typename Offset, typename Valid>
__device__ __forceinline__ void sweep(WarpState<HD, QPK>& st,
                                      Smem<HD, QPK>& sm, const T* k,
                                      const T* v, int t_begin, int t_end,
                                      float scale, Offset offset,
                                      Valid valid) {
  constexpr int VEC = HD / 32;
  constexpr int CH = 16 / sizeof(T);        // elements per 16-byte load
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float(&p)[QPK][TILE] = sm.p[warp];
  for (int t0 = t_begin + warp * TILE; t0 < t_end; t0 += WARPS * TILE) {
    const int t = t0 + lane;
    const bool ok = t < t_end && valid(t);
    const unsigned mask = __ballot_sync(FULL, ok);
    if (mask == 0) continue;
    int64_t off = 0;
    float s[QPK];
#pragma unroll
    for (int h = 0; h < QPK; ++h) s[h] = 0.f;
    if (ok) {
      off = offset(t);
      const T* krow = k + off;
#pragma unroll
      for (int d = 0; d < HD; d += CH) {
        float kc[CH];
        load_vec<T, CH>(krow + d, kc);
#pragma unroll
        for (int h = 0; h < QPK; ++h)
#pragma unroll
          for (int i = 0; i < CH; ++i) s[h] += sm.q[h][d + i] * kc[i];
      }
    }
#pragma unroll
    for (int h = 0; h < QPK; ++h) {
      const float sc = ok ? s[h] * scale : NEG_INF;
      const float m_new = fmaxf(st.m[h], warp_max(sc));
      const float alpha = expf(st.m[h] - m_new);
      const float e = ok ? expf(sc - m_new) : 0.f;
      st.l[h] = st.l[h] * alpha + warp_sum(e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) st.acc[h][i] *= alpha;
      st.m[h] = m_new;
      p[h][lane] = e;
    }
    __syncwarp();
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += 4) {
      float vv[4][VEC];
      bool have[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        const int64_t off_j = __shfl_sync(FULL, (long long)off, j);
        have[u] = (mask >> j) & 1u;
        if (have[u]) load_vec<T, VEC>(v + off_j + lane * VEC, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!have[u]) continue;
#pragma unroll
        for (int h = 0; h < QPK; ++h) {
          const float pj = p[h][j0 + u];
#pragma unroll
          for (int i = 0; i < VEC; ++i) st.acc[h][i] += pj * vv[u][i];
        }
      }
    }
    __syncwarp();
  }
}

// Merge the block's WARPS partial states in shared memory and write one
// partial per query head of this (row, kv_head, split):
//   part_m/part_l: [row][kv_head][split][QPK]
//   part_acc:      [row][kv_head][split][QPK][HD]
template <int HD, int QPK>
__device__ __forceinline__ void merge_warps_and_store(
    const WarpState<HD, QPK>& st, Smem<HD, QPK>& sm, float* part_m,
    float* part_l, float* part_acc, int64_t part_idx) {
  constexpr int VEC = HD / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < QPK; ++h) {
    if (lane == 0) {
      sm.m[warp][h] = st.m[h];
      sm.l[warp][h] = st.l[h];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm.acc[warp][h][lane * VEC + i] = st.acc[h][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < QPK * HD; idx += THREADS) {
    const int h = idx / HD;
    const int d = idx % HD;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, sm.m[w][h]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm.m[w][h] - m);
      l += sm.l[w][h] * c;
      a += sm.acc[w][h][d] * c;
    }
    part_acc[(part_idx * QPK + h) * HD + d] = a;
    if (d == 0) {
      part_m[part_idx * QPK + h] = m;
      part_l[part_idx * QPK + h] = l;
    }
  }
}

// Mark this block's split empty (no valid token): only (m, l) are
// written, and combine_kernel skips the split.
template <int QPK>
__device__ __forceinline__ void store_empty(float* part_m, float* part_l,
                                            int64_t part_idx) {
  if (threadIdx.x < QPK) {
    part_m[part_idx * QPK + threadIdx.x] = NEG_INF;
    part_l[part_idx * QPK + threadIdx.x] = 0.f;
  }
}

// Merge the nsplit partials of each (row, query head) and write the
// normalised output, (B, H*HD) in T. Grid: B * H blocks of HD threads.
// Inactive rows get exact zeros and their partials are never read. A
// split that saw no valid token has l = 0 and drops out of the sums; l
// is floored at 1e-30 as in the Pallas kernels, so a row with no valid
// token at all also yields zeros.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               const uint8_t* __restrict__ active,
                               T* __restrict__ out, int H, int qpk, int HD,
                               int nsplit) {
  const int row = blockIdx.x / H;
  const int head = blockIdx.x % H;
  const int d = threadIdx.x;
  T* dst = out + (int64_t)blockIdx.x * HD + d;
  if (!active[row]) {
    *dst = from_f<T>(0.f);
    return;
  }
  const int g = head / qpk;
  const int h = head % qpk;
  const int hkv = H / qpk;
  const int64_t base = ((int64_t)row * hkv + g) * nsplit;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    m = fmaxf(m, part_m[(base + s) * qpk + h]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t i = (base + s) * qpk + h;
    if (part_l[i] > 0.f) {            // a split with no valid token wrote
      const float c = expf(part_m[i] - m);   // only (m, l) = (-1e30, 0)
      l += part_l[i] * c;
      a += part_acc[i * HD + d] * c;
    }
  }
  *dst = from_f<T>(a / fmaxf(l, 1e-30f));
}

// Launch combine_kernel for `dtype` (0 = float32, 1 = bfloat16).
inline void launch_combine(int dtype, const float* part_m,
                           const float* part_l, const float* part_acc,
                           const uint8_t* active, void* out, int B, int H,
                           int qpk, int HD, int nsplit, cudaStream_t stream) {
  if (dtype == 0)
    combine_kernel<float><<<B * H, HD, 0, stream>>>(
        part_m, part_l, part_acc, active, static_cast<float*>(out), H, qpk,
        HD, nsplit);
  else
    combine_kernel<__nv_bfloat16><<<B * H, HD, 0, stream>>>(
        part_m, part_l, part_acc, active, static_cast<__nv_bfloat16*>(out), H,
        qpk, HD, nsplit);
}

}  // namespace decode

// Message for an error code a *_launch function returned.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Instantiate KERNEL<T, HD, QPK> for the supported shapes and launch it
// with the remaining arguments; `dtype` 0 = float32, 1 = bfloat16. Leaves
// the error code in `err` (cudaErrorInvalidValue for an unsupported
// shape).
#define DECODE_DISPATCH(KERNEL, GRID, dtype, hd, qpk, stream, ...)           \
  do {                                                                      \
    auto go = [&](auto t_tag, auto hd_tag, auto qpk_tag) {                   \
      using T = decltype(t_tag);                                            \
      constexpr int D = decltype(hd_tag)::value;                            \
      constexpr int Q = decltype(qpk_tag)::value;                           \
      KERNEL<T, D, Q><<<GRID, decode::THREADS, 0, stream>>>(__VA_ARGS__);   \
    };                                                                      \
    auto by_qpk = [&](auto t_tag, auto hd_tag) {                             \
      switch (qpk) {                                                        \
        case 1: go(t_tag, hd_tag, std::integral_constant<int, 1>{}); break;  \
        case 2: go(t_tag, hd_tag, std::integral_constant<int, 2>{}); break;  \
        case 4: go(t_tag, hd_tag, std::integral_constant<int, 4>{}); break;  \
        case 8: go(t_tag, hd_tag, std::integral_constant<int, 8>{}); break;  \
        default: err = cudaErrorInvalidValue;                               \
      }                                                                     \
    };                                                                      \
    auto by_hd = [&](auto t_tag) {                                          \
      switch (hd) {                                                         \
        case 64: by_qpk(t_tag, std::integral_constant<int, 64>{}); break;    \
        case 128: by_qpk(t_tag, std::integral_constant<int, 128>{}); break;  \
        default: err = cudaErrorInvalidValue;                               \
      }                                                                     \
    };                                                                      \
    if (dtype == 0) by_hd(float{});                                         \
    else if (dtype == 1) by_hd(__nv_bfloat16{});                            \
    else err = cudaErrorInvalidValue;                                       \
  } while (0)
