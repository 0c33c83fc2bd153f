// TextRank: damped PageRank over a sentence-similarity matrix, the C&R
// compressor's centrality score. Replaces the Pallas kernel
// _textrank_kernel / textrank_pallas of src/repro/kernels/textrank.py.
//
// sim (N, N) f32, row stride ld; out (N,) f32. The kernel zeroes the
// diagonal, takes column sums (a sum <= 0 counts as 1), and from p = 1/N
// runs `iters` steps of
//     p[i] = (1 - d) / N + d * sum_{j != i} sim[i, j] * (p[j] / colsum[j])
// which is numpy's order (w @ (p / colsum)); the plain PyTorch version
// and the Pallas kernel normalise W first (wn @ p). The two orders agree
// to f32 rounding.
//
// Design: one block of 1024 threads per matrix, so the 30 dependent steps
// need no grid-wide sync and the whole call is one launch. The column
// sums take one thread per column (coalesced row reads). Each step writes
// q = p / colsum to shared memory, then each warp takes rows and its
// lanes stride over the row's columns (coalesced), reduce with shuffles,
// and lane 0 writes the row's new p. p, q and colsum take 12 N bytes of
// shared memory. When the matrix itself also fits (N <= 239 sentences,
// which covers the gateway's prompts), it is staged into shared memory
// once and the steps read it from there.
//
// Bound on an H100: the matrix is read from device memory once, N^2 * 4
// bytes at 3.35 TB/s, against 30 * 2 N^2 f32 operations at 67 TFLOP/s:
// bytes bound it (1.25 us at N = 1024). This kernel sits far from that:
// past N = 239 one SM re-reads the matrix from L2 on each of the 30
// steps, at one SM's L2 bandwidth, and every step pays two block-wide
// barriers. The later design spreads the matrix over a thread-block
// cluster of up to 16 SMs in distributed shared memory (16 x 227 KB
// holds N ~ 950 in f32), or splits each matvec over many blocks and puts
// the 30 launches into a CUDA graph.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;   // per block, opt-in (H100)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
textrank_kernel(const float* __restrict__ sim, int n, int64_t ld,
                float damping, int iters, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* colsum = smem;           // column sums, a sum <= 0 set to 1
  float* p = smem + n;            // the PageRank vector
  float* q = smem + 2 * n;        // p / colsum
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* m = sim;
  int64_t mld = ld;
  if (STAGED) {
    float* w = smem + 3 * n;      // the matrix, row-major, stride n
    for (int64_t e = tid; e < (int64_t)n * n; e += THREADS)
      w[e] = sim[(e / n) * ld + e % n];
    __syncthreads();
    m = w;
    mld = n;
  }
  for (int j = tid; j < n; j += THREADS) {
    float s = 0.f;
    for (int i = 0; i < n; ++i)
      if (i != j) s += m[i * mld + j];
    colsum[j] = s <= 0.f ? 1.f : s;
    p[j] = 1.f / n;
  }
  const float base = (1.f - damping) / n;
  for (int it = 0; it < iters; ++it) {
    __syncthreads();              // p (and colsum) complete
    for (int j = tid; j < n; j += THREADS) q[j] = p[j] / colsum[j];
    __syncthreads();              // q complete; p may be overwritten
    for (int i = warp; i < n; i += WARPS) {
      const float* row = m + i * mld;
      float acc = 0.f;
      for (int j = lane; j < n; j += 32)
        acc += (j == i ? 0.f : row[j]) * q[j];
      acc = warp_sum(acc);
      if (lane == 0) p[i] = base + damping * acc;
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += THREADS) out[j] = p[j];
}

template <bool STAGED>
cudaError_t launch(const float* sim, int n, int64_t ld, float damping,
                   int iters, float* out, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        textrank_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  textrank_kernel<STAGED><<<1, THREADS, smem, stream>>>(sim, n, ld, damping,
                                                        iters, out);
  return cudaGetLastError();
}

}  // namespace

// n >= 1 sentences with 12 n bytes of vectors within MAX_SMEM (the
// wrapper checks this first); the matrix is staged when it fits too.
extern "C" int textrank_launch(const float* sim, int n, int64_t ld,
                               float damping, int iters, float* out,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t vecs = 3 * (int64_t)n * sizeof(float);
  const int64_t staged = vecs + (int64_t)n * n * sizeof(float);
  if (n < 1 || vecs > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (staged <= MAX_SMEM)
    return (int)launch<true>(sim, n, ld, damping, iters, out, staged, stream);
  return (int)launch<false>(sim, n, ld, damping, iters, out, vecs, stream);
}

// Message for an error code textrank_launch returned.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
