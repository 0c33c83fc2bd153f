// Flash-decode GQA attention over the dense (row-per-slot) KV cache, one
// new token per row. Replaces the Pallas kernel _decode_kernel /
// gqa_decode of src/repro/kernels/gqa_decode.py.
//
// q (B, H, HD); K/V (B, S, Hkv, HD) token-major, read through their batch
// and token strides (no transposed copy); valid (B, S) bool, which need
// not be a prefix; active (B,) bool. Out (B, H*HD) in q's type.
//
// Bound on an H100: bytes. Each valid token costs 2 * Hkv * HD * sizeof(T)
// bytes of K/V against 4 * H * HD flops, 2 * q_per_kv / sizeof(T) flops
// per byte (4 at q_per_kv = 4 in bf16), far under the card's ~295. What
// the design (decode_common.cuh) does about it:
//   1. the work follows the live tokens, not the cache's capacity: S is
//      cut into 64-token items dealt round robin to the 8 blocks of one
//      cluster per (row, kv head), so a live 1,100-token row keeps 64
//      SMs reading; the items' 64 valid bytes are read first, and items
//      with no valid token are never staged;
//   2. each block requests the K and V tiles of its next items by
//      cp.async.cg before any compute, 32 KB an item in bf16, refilling a
//      2-stage shared-memory ring as it consumes it: ~190 KB per SM in
//      flight;
//   3. a token's 256-byte head row is copied whole by 16 lanes, so every
//      sector fetched is used; masked tokens are never loaded; the scores
//      and P.V run on the tensor cores in bf16 (mma.sync), P as a bf16
//      hi/lo pair, so P.V keeps the reference's f32 weights;
//   4. the 8 blocks of a cluster merge their states through distributed
//      shared memory in the same launch, in rank order: no second launch
//      and no partials in device memory.
#include "decode_common.cuh"

namespace {

template <typename T, int HD, int NH>
__global__ void __launch_bounds__(decode::THREADS)
    gqa_decode_cluster(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ valid,
                       const uint8_t* __restrict__ active, T* __restrict__ out,
                       int S, int H, int qpk, int64_t kv_sb, int64_t kv_ss,
                       int n_items, float scale) {
  const int row = blockIdx.z;
  const uint8_t* vrow = valid + (int64_t)row * S;
  const int64_t base = (int64_t)row * kv_sb + (int64_t)blockIdx.y * HD;
  decode::attend<T, HD, NH>(
      q, k, v, active, out, n_items, H, qpk, scale, [&](int t) -> int64_t {
        return t < S && vrow[t] ? base + t * kv_ss : -1;
      });
}

}  // namespace

extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const uint8_t* valid, const uint8_t* active,
                                 void* out, int B, int S, int H, int Hkv,
                                 int HD, int64_t kv_sb, int64_t kv_ss,
                                 int n_items, float scale, int dtype,
                                 void* stream_ptr) {
  const int qpk = decode::q_per_kv(H, Hkv);
  if (!decode::items_ok(n_items, S) || qpk == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(decode::CL, Hkv, B);
  return (int)decode::dispatch(
      dtype, HD, qpk, [&](auto t_tag, auto hd_tag, auto nh_tag) {
        using T = decltype(t_tag);
        constexpr int D = decltype(hd_tag)::value;
        constexpr int N = decltype(nh_tag)::value;
        return decode::launch<T, D, N>(
            gqa_decode_cluster<T, D, N>, grid, stream,
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), valid, active, static_cast<T*>(out), S,
            H, qpk, kv_sb, kv_ss, n_items, scale);
      });
}
