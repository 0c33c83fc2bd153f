// Flash-decode GQA attention over the dense (row-per-slot) KV cache, one
// new token per row. Replaces the Pallas kernel _decode_kernel /
// gqa_decode of src/repro/kernels/gqa_decode.py.
//
// q (B, H, HD); K/V (B, S, Hkv, HD) token-major, read through their batch
// and token strides (no transposed copy); valid (B, S) bool, which need
// not be a prefix; active (B,) bool. Out (B, H*HD) in q's type.
//
// Bound on an H100: bytes. Each valid token costs 2 * Hkv * HD * sizeof(T)
// bytes of K/V against 4 * H * HD flops, about 2 * q_per_kv / sizeof(T)
// flops per byte, far under the card's ~295. The design therefore aims
// at memory traffic: each K/V byte of a valid token is read once, a
// masked token's K/V (and a fully masked tile) is never loaded, inactive
// rows read nothing, and S is split so that even one live row spreads
// over many SMs (see decode_common.cuh for the work split).
#include <type_traits>

#include "decode_common.cuh"

namespace {

template <typename T, int HD, int QPK>
__global__ void __launch_bounds__(decode::THREADS)
gqa_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ active,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int S, int H, int Hkv,
                   int64_t kv_sb, int64_t kv_ss, int chunk, float scale) {
  __shared__ decode::Smem<HD, QPK> sm;
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int row = blockIdx.z;
  if (!active[row]) return;          // combine_kernel writes the zeros
  decode::WarpState<HD, QPK> st;
  st.init();
  decode::stage_q<T, HD, QPK>(sm, q, row, H, g);
  const uint8_t* vrow = valid + (int64_t)row * S;
  const int64_t base = (int64_t)row * kv_sb + (int64_t)g * HD;
  const int start = split * chunk;
  decode::sweep<T, HD, QPK>(
      st, sm, k, v, start, min(S, start + chunk), scale,
      [&](int t) { return base + t * kv_ss; },
      [&](int t) { return vrow[t] != 0; });
  const int64_t part_idx = ((int64_t)row * Hkv + g) * gridDim.x + split;
  decode::merge_warps_and_store<HD, QPK>(st, sm, part_m, part_l, part_acc,
                                         part_idx);
}

}  // namespace

extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const uint8_t* valid, const uint8_t* active,
                                 void* out, float* part_m, float* part_l,
                                 float* part_acc, int B, int S, int H, int Hkv,
                                 int HD, int64_t kv_sb, int64_t kv_ss,
                                 int nsplit, float scale, int dtype,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  const int qpk = H / Hkv;
  const int chunk = (S + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, Hkv, B);
  DECODE_DISPATCH(gqa_decode_partial, grid, dtype, HD, qpk, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), valid, active, part_m, part_l,
                  part_acc, S, H, Hkv, kv_sb, kv_ss, chunk, scale);
  if (err != cudaSuccess) return (int)err;
  decode::launch_combine(dtype, part_m, part_l, part_acc, active, out, B, H,
                         qpk, HD, nsplit, stream);
  return (int)cudaGetLastError();
}
