// Flash-decode GQA attention over the paged KV block pool, one new token
// per row. Replaces the Pallas kernel _paged_decode_kernel /
// paged_gqa_decode of src/repro/kernels/paged_decode.py.
//
// q (B, H, HD); pages (P, BLOCK_S, Hkv, HD) token-major, read through
// their block and token strides; block_tables (B, NB) int32; seq_lens (B,)
// int32 (pos + 1); active (B,) bool. Out (B, H*HD) in q's type.
//
// Token t of row b lives in physical block block_tables[b, t / BLOCK_S],
// clamped to [0, P-1], at offset t % BLOCK_S. Each block reads the table
// entries of its own items, and only those of tokens below seq_len, so a
// row may alias blocks of another row (prefix sharing) and a stale entry
// past seq_len is never dereferenced.
//
// Bound on an H100: bytes, 2 * q_per_kv / sizeof(T) flops per byte
// against the card's ~295, as for gqa_decode.cu, and the same design
// (decode_common.cuh): 64-token items of the logical token axis dealt to
// the 8 blocks of one cluster per (row, kv head) (items past seq_len are
// never staged), K and V tiles requested ahead by cp.async.cg into a
// shared-memory ring, whole 256-byte head rows per token, bf16 products
// on the tensor cores, and the blocks' states merged in rank order
// through distributed shared memory in the same launch. Items, their
// order and the merge are those of the dense kernel for the same extent,
// so a paged row and a dense row holding the same tokens give the same
// bits.
#include "decode_common.cuh"

namespace {

template <typename T, int HD, int NH>
__global__ void __launch_bounds__(decode::THREADS)
    paged_decode_cluster(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ seq_lens,
                         const uint8_t* __restrict__ active,
                         T* __restrict__ out, int H, int qpk, int P, int BS,
                         int NB, int64_t p_sp, int64_t p_ss, int n_items,
                         float scale) {
  const int row = blockIdx.z;
  const int32_t* bt = block_tables + (int64_t)row * NB;
  const int64_t head = (int64_t)blockIdx.y * HD;
  const int end = min(seq_lens[row], NB * BS);
  decode::attend<T, HD, NH>(
      q, k, v, active, out, n_items, H, qpk, scale, [&](int t) -> int64_t {
        if (t >= end) return -1;
        const int phys = min(max(bt[t / BS], 0), P - 1);
        return (int64_t)phys * p_sp + (t % BS) * p_ss + head;
      });
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const int32_t* block_tables,
                                   const int32_t* seq_lens,
                                   const uint8_t* active, void* out, int B,
                                   int H, int Hkv, int HD, int P, int BS,
                                   int NB, int64_t p_sp, int64_t p_ss,
                                   int n_items, float scale, int dtype,
                                   void* stream_ptr) {
  const int qpk = decode::q_per_kv(H, Hkv);
  if (!decode::items_ok(n_items, NB * BS) || qpk == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(decode::CL, Hkv, B);
  return (int)decode::dispatch(
      dtype, HD, qpk, [&](auto t_tag, auto hd_tag, auto nh_tag) {
        using T = decltype(t_tag);
        constexpr int D = decltype(hd_tag)::value;
        constexpr int N = decltype(nh_tag)::value;
        return decode::launch<T, D, N>(
            paged_decode_cluster<T, D, N>, grid, stream,
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), block_tables, seq_lens, active,
            static_cast<T*>(out), H, qpk, P, BS, NB, p_sp, p_ss, n_items,
            scale);
      });
}
