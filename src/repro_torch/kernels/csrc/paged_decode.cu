// Flash-decode GQA attention over the paged KV block pool, one new token
// per row. Replaces the Pallas kernel _paged_decode_kernel /
// paged_gqa_decode of src/repro/kernels/paged_decode.py.
//
// q (B, H, HD); pages (P, BLOCK_S, Hkv, HD) token-major, read through
// their block and token strides; block_tables (B, NB) int32; seq_lens (B,)
// int32 (pos + 1); active (B,) bool. Out (B, H*HD) in q's type.
//
// Token t of row b lives in physical block block_tables[b, t / BLOCK_S],
// clamped to [0, P-1], at offset t % BLOCK_S. Each lane loads the table
// entry of the token it reads, so a row may alias blocks of another row
// (prefix sharing) and a stale entry past seq_len is never dereferenced:
// tokens t >= seq_len are skipped, and a split past seq_len exits.
//
// Bound on an H100: bytes, as for gqa_decode.cu. Each K/V byte of the
// row's first seq_len tokens is read once; nothing past seq_len and
// nothing of an inactive row is read.
#include <type_traits>

#include "decode_common.cuh"

namespace {

template <typename T, int HD, int QPK>
__global__ void __launch_bounds__(decode::THREADS)
paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int32_t* __restrict__ block_tables,
                     const int32_t* __restrict__ seq_lens,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, int H, int Hkv, int P,
                     int BS, int NB, int64_t p_sp, int64_t p_ss, int chunk,
                     float scale) {
  __shared__ decode::Smem<HD, QPK> sm;
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int row = blockIdx.z;
  if (!active[row]) return;          // combine_kernel writes the zeros
  const int64_t part_idx = ((int64_t)row * Hkv + g) * gridDim.x + split;
  const int start = split * chunk;
  const int end = min(min(NB * BS, start + chunk), seq_lens[row]);
  if (start >= end) {                 // the split lies past seq_len
    decode::store_empty<QPK>(part_m, part_l, part_idx);
    return;
  }
  decode::WarpState<HD, QPK> st;
  st.init();
  decode::stage_q<T, HD, QPK>(sm, q, row, H, g);
  const int32_t* bt = block_tables + (int64_t)row * NB;
  decode::sweep<T, HD, QPK>(
      st, sm, k, v, start, end, scale,
      [&](int t) {
        const int phys = min(max(bt[t / BS], 0), P - 1);
        return (int64_t)phys * p_sp + (t % BS) * p_ss + (int64_t)g * HD;
      },
      [](int) { return true; });
  decode::merge_warps_and_store<HD, QPK>(st, sm, part_m, part_l, part_acc,
                                         part_idx);
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const int32_t* block_tables,
                                   const int32_t* seq_lens,
                                   const uint8_t* active, void* out,
                                   float* part_m, float* part_l,
                                   float* part_acc, int B, int H, int Hkv,
                                   int HD, int P, int BS, int NB,
                                   int64_t p_sp, int64_t p_ss, int nsplit,
                                   float scale, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  const int qpk = H / Hkv;
  const int chunk = (NB * BS + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, Hkv, B);
  DECODE_DISPATCH(paged_decode_partial, grid, dtype, HD, qpk, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), block_tables, seq_lens, active,
                  part_m, part_l, part_acc, H, Hkv, P, BS, NB, p_sp, p_ss,
                  chunk, scale);
  if (err != cudaSuccess) return (int)err;
  decode::launch_combine(dtype, part_m, part_l, part_acc, active, out, B, H,
                         qpk, HD, nsplit, stream);
  return (int)cudaGetLastError();
}
