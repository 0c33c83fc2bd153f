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
// Bound on an H100: the matrix is read from device memory once, N^2 * 4
// bytes at 3.35 TB/s, against 30 * 2 N^2 f32 operations at 67 TFLOP/s:
// bytes bound it (1.25 us at N = 1024). The 30 steps depend on each
// other, so what a call costs past that is the latency of handing each
// step's vector to every SM.
//
// Design: one cooperative launch of G co-resident blocks
// (cudaLaunchCooperativeKernel: the launch waits for room for all G, so
// the waits below cannot deadlock behind the engines' kernels). Block g
// owns rows [g R, min(N, (g + 1) R)) and the same columns.
//   1. It stages its rows into shared memory once, the diagonal zeroed,
//      so the matrix is read from HBM once, spread over G SMs (8 rows,
//      32 KB a block at N = 1024). Rows that do not fit are read from
//      global memory on every step instead (N up to 19,370).
//   2. Column sums: each block writes the partial sums of its rows for
//      every column to scratch [G][N]; after the call's one grid barrier
//      each block adds the partials of its own columns in g order (no
//      atomics: two calls give the same bits) and publishes q = (1/N) /
//      colsum.
//   3. Each step, the block gathers q = p / colsum (N floats) into shared
//      memory, one warp takes ROWS_AT_ONCE rows' dot products, reduced
//      with shuffles, and it publishes its rows' next q (or writes p, at
//      the last step). q is double-buffered in global memory as 64-bit
//      words holding the float and the step's tag, written and read
//      whole through L2, so a reader that sees the tag sees the value:
//      each block waits on the words it reads, and a step needs no grid
//      barrier (a fence, an atomic and a poll through L2 before q could
//      be read at all; a grid barrier a step measured 17-50% slower at
//      N = 239-1024, PERF.md, section 6). A block can publish step t + 2
//      into a buffer only after every block has published step t + 1,
//      which each did after reading step t from it, so two buffers do.
//      The words are zeroed before the grid barrier, so no tag of an
//      earlier call is read. Every block is resident (the cooperative
//      launch), so every wait ends.
// G = 1 (N <= SINGLE_MAX in kernels/textrank.py) exchanges nothing: q is
// double-buffered in shared memory and a step costs one block barrier.
// kernels/textrank.py::grid_plan picks G, R and the block size from N and
// the occupancy query below (textrank_block, which also says how much
// shared memory the launch gives a block of the plan and whether its rows
// are staged); its rule was measured on an H100 (chip_smoke.py phase 3
// prints the sweep; PERF.md, section 6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 232448;   // per block, opt-in (H100)
constexpr int MAX_DEVICES = 64;
constexpr int BATCH = 8;           // loads a thread keeps in flight
constexpr int ROWS_AT_ONCE = 4;    // rows a warp takes per pass

using u64 = unsigned long long;

// q's words: the float's bits and the tag in one 64-bit word, stored and
// loaded whole at the device's coherence point (single-copy atomic).
__device__ __forceinline__ void publish(u64* p, float v, unsigned tag) {
  const u64 x = (static_cast<u64>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(x)
               : "memory");
}

__device__ __forceinline__ u64 peek(const u64* p) {
  u64 x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p)
               : "memory");
  return x;
}

// Poll a word until it holds the tag `want`, backing off between polls
// (every block polls L2). Out of line, so the gather's batch of loads
// stays tight: inlined, the wait slowed N = 512-1024 by 10-14% (PERF.md,
// section 6).
__device__ __noinline__ u64 wait_word(const u64* p, unsigned want) {
  u64 x;
  do {
    __nanosleep(32);
    x = peek(p);
  } while (static_cast<unsigned>(x >> 32) != want);
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory, in bytes, of a block: q ([2][N] when G = 1, else [N]),
// the column sums of the block's R rows, and the R rows themselves when
// they fit MAX_SMEM (*staged).
int64_t block_smem(int n, int rows, int grid, bool* staged) {
  const int64_t vectors = 4 * ((int64_t)(grid == 1 ? 2 : 1) * n + rows);
  const int64_t with_rows = vectors + 4 * (int64_t)rows * n;
  *staged = with_rows <= MAX_SMEM;
  return *staged ? with_rows : vectors;
}

template <bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS)
textrank_grid(const float* __restrict__ sim, int n, int64_t ld, int rows,
              float damping, int iters, float* __restrict__ colpart,
              u64* __restrict__ qx, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int G = gridDim.x, g = blockIdx.x;
  const int r0 = g * rows, r1 = min(n, r0 + rows);
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  float* qs = smem;                          // q, this step (and next: G = 1)
  float* cs = qs + (G == 1 ? 2 * n : n);     // colsum of rows r0..r1-1
  float* ws = cs + rows;                     // staged rows, stride n
  // row i of W (the diagonal zeroed when staged; see `w`)
  auto row = [&](int i) -> const float* {
    return STAGED ? ws + (int64_t)(i - r0) * n : sim + i * ld;
  };
  auto w = [&](const float* r, int i, int j) -> float {
    return STAGED || j != i ? r[j] : 0.f;
  };
  if (STAGED) {                  // rows r0.. in BATCH loads a thread
    const int total = (r1 - r0) * n;
    for (int e0 = tid; e0 < total; e0 += BATCH * T) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * T, i = r0 + e / n, j = e % n;
        v[u] = e < total && j != i ? sim[i * ld + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (e0 + u * T < total) ws[e0 + u * T] = v[u];
    }
    __syncthreads();
  }
  if (G == 1) {
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int i = 0; i < n; ++i) s += w(row(i), i, j);
      const float c = s <= 0.f ? 1.f : s;
      cs[j] = c;
      qs[j] = (1.f / n) / c;
    }
    __syncthreads();
  } else {
    for (int j = r0 + tid; j < r1; j += T) {   // no tag of an earlier call
      qx[j] = 0;
      qx[n + j] = 0;
    }
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int i = r0; i < r1; ++i) s += w(row(i), i, j);
      colpart[(int64_t)g * n + j] = s;
    }
    cg::this_grid().sync();
    for (int j = r0 + tid; j < r1; j += T) {
      float s = 0.f;                 // in g order, BATCH loads in flight
      for (int h0 = 0; h0 < G; h0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          v[u] = h0 + u < G ? __ldcg(colpart + (int64_t)(h0 + u) * n + j)
                            : 0.f;
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (h0 + u < G) s += v[u];
      }
      const float c = s <= 0.f ? 1.f : s;
      cs[j - r0] = c;
      publish(qx + j, (1.f / n) / c, 1);      // q of step 0: tag 1
    }
  }
  const float base = (1.f - damping) / n;
  for (int it = 0; it < iters; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const bool last = it == iters - 1;
    const float* q = qs + (G == 1 ? cur * n : 0);
    if (G > 1) {                 // gather q of step `it`: tag it + 1
      const u64* src = qx + cur * n;
      const unsigned want = it + 1;
      for (int j0 = tid; j0 < n; j0 += BATCH * T) {
        u64 v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          v[u] = j0 + u * T < n ? peek(src + j0 + u * T) : 0;
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int j = j0 + u * T;
          if (j >= n) continue;
          if (static_cast<unsigned>(v[u] >> 32) != want)
            v[u] = wait_word(src + j, want);
          qs[j] = __uint_as_float(static_cast<unsigned>(v[u]));
        }
      }
      __syncthreads();
    }
    // warp w takes rows w, w + W, ..., ROWS_AT_ONCE at a time, so their
    // dot products and shuffle reductions overlap
    for (int i0 = r0 + warp; i0 < r1; i0 += ROWS_AT_ONCE * W) {
      float acc[ROWS_AT_ONCE] = {};
      for (int j = lane; j < n; j += 32) {
        const float qj = q[j];
#pragma unroll
        for (int u = 0; u < ROWS_AT_ONCE; ++u) {
          const int i = i0 + u * W;
          if (i < r1) acc[u] += w(row(i), i, j) * qj;
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS_AT_ONCE; ++u) acc[u] = warp_sum(acc[u]);
      // lane u finishes row i0 + u W: the divisions run side by side
      float dot = acc[0];
#pragma unroll
      for (int u = 1; u < ROWS_AT_ONCE; ++u)
        if (lane == u) dot = acc[u];
      const int i = i0 + lane * W;
      if (lane < ROWS_AT_ONCE && i < r1) {
        const float p = base + damping * dot;
        if (last)
          out[i] = p;
        else if (G == 1)
          qs[nxt * n + i] = p / cs[i];
        else
          publish(qx + nxt * n + i, p / cs[i - r0], it + 2);
      }
    }
    if (!last) __syncthreads();    // qs is read, or rewritten, next
  }
  if (iters == 0)
    for (int i = r0 + tid; i < r1; i += T) out[i] = 1.f / n;
}

using Kernel = void (*)(const float*, int, int64_t, int, float, int, float*,
                        u64*, float*);

Kernel kernel_of(bool staged) {
  return staged ? textrank_grid<true> : textrank_grid<false>;
}

// Raise both instantiations' shared-memory limit to MAX_SMEM, once per
// device (the limit belongs to the current device).
cudaError_t raise_smem_limit() {
  static std::atomic<bool> raised[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  for (bool staged : {true, false}) {
    e = cudaFuncSetAttribute(kernel_of(staged),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return e;
  }
  if (dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// The block that textrank_launch makes for the plan (n, rows, grid,
// threads): writes its dynamic shared memory in bytes and whether its rows
// are staged, and returns how many such blocks fit on one SM at once (the
// occupancy query, after the limit is raised as for the launch), or minus
// a CUDA error code.
extern "C" int textrank_block(int n, int rows, int grid, int threads,
                              int* smem, int* staged) {
  bool st = false;
  *smem = (int)block_smem(n, rows, grid, &st);
  *staged = st;
  cudaError_t e = raise_smem_limit();
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(st),
                                                    threads, *smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// One cooperative launch of `grid` blocks of `threads` threads, block g
// owning rows [g rows, min(n, (g + 1) rows)), staged when they fit.
// colpart ([grid][n] f32) and qbuf ([2][n] 64-bit words, 8-byte aligned)
// are scratch, needed when grid > 1. The plan must cover every row exactly
// once and fit shared memory.
extern "C" int textrank_launch(const float* sim, int n, int64_t ld,
                               int rows, int grid, int threads,
                               float damping, int iters, float* colpart,
                               u64* qbuf, float* out, void* stream_ptr) {
  if (n < 1 || rows < 1 || grid < 1 || iters < 0 ||
      (int64_t)grid * rows < n || (int64_t)(grid - 1) * rows >= n ||
      threads < 32 || threads > MAX_THREADS || threads % 32 ||
      (grid > 1 && (colpart == nullptr || qbuf == nullptr ||
                    reinterpret_cast<uintptr_t>(qbuf) % 8)))
    return (int)cudaErrorInvalidValue;
  bool staged = false;
  const int64_t smem = block_smem(n, rows, grid, &staged);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = raise_smem_limit();
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&sim, &n, &ld, &rows, &damping, &iters, &colpart, &qbuf,
                  &out};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of(staged)), dim3(grid),
      dim3(threads), args, (size_t)smem,
      static_cast<cudaStream_t>(stream_ptr));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Message for an error code textrank_launch returned.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
