// Shared body of the two flash-decode GQA kernels (gqa_decode.cu,
// paged_decode.cu).
//
// Work split. A row's token axis (S, or NB * BLOCK_S) is cut into 64-token
// work items. Each (row, kv head) gets one thread-block cluster of CL = 8
// blocks, and block r of the cluster takes items r, r + 8, r + 16, ...,
// so the live items of a row are spread over 8 blocks and Hkv clusters,
// whatever its length: a live 1,100-token row (18 items) keeps 64 SMs
// reading, 2-3 items each. The grid, (8, Hkv, B), depends on shapes
// only: the host reads no length back and the launch has a fixed shape.
// A cluster of an inactive row exits at once (rank 0 writes the zeros).
//
// Head shapes. HD is 64, 128 or 192; the group's q_per_kv query heads
// (1-16, a run-time argument) are padded with zero queries to NH: in
// bf16 NT = NH / 8 = 1 or 2 n8 tiles of the MMA, in f32 NH = 4, 8 or 16
// (the FMA loops stay unrolled and branch-free: a run-time guard per head
// slowed the f32 path by half or more on an H100, PERF.md section 6).
// Instantiations: 3 head dims x 5 NH (2 in bf16, 3 in f32).
//
// One block (4 warps):
//   1. scans its items: the 64 threads of each item resolve their
//      token's K/V row offset, or -1 for a masked token or one past the
//      row's extent (paged: the block table is read only for tokens below
//      seq_len), all items' loads in flight together; the items with an
//      attended token form the block's live list, in item order;
//   2. walks the live list through a ring of shared-memory stages (2 in
//      bf16, 1 in f32): the K tile and the V tile of the next items are
//      requested as cp.async.cg groups of 16-byte copies (through L2,
//      bypassing L1) before any compute, and each stage is refilled as
//      soon as it is consumed. Rows are padded by 8 elements (at HD = 192
//      a 400-byte row rotates ldmatrix's rows by 4 banks), so ldmatrix
//      reads are free of bank conflicts; a masked token's rows are
//      zero-filled and never loaded. ~73 KB a block in bf16 at HD = 128,
//      3 blocks per SM: up to ~190 KB of K/V requested per SM; ~108 KB at
//      HD = 192, 2 blocks per SM. (A third stage, or clusters of 16, leave
//      fewer clusters resident and measured slower on an H100: PERF.md,
//      section 6);
//   3. scores S^T = K.Q^T. bf16: mma.sync m16n8k16 with the tile's tokens
//      as M (one 16-token slice per warp), the padded query heads as N
//      (NT tiles, sharing each K fragment) and HD as K, Q held in
//      registers. f32: FMAs from shared memory, two lanes per token
//      (TF32 would not hold the f32 model's 1e-5 parity);
//   4. online softmax in f32 across the block's items: the running max
//      per head, p = exp(s - m) written to shared memory in T, the
//      rescale factor alpha = exp(m_old - m) applied to l and acc;
//   5. O^T += V^T.P^T. bf16: mma.sync m16n8k16 with dims as M (HD / 64
//      16-dim slices per warp), heads as N, tokens as K, V read by
//      ldmatrix.trans. P is split into a bf16 pair, hi = bf16(p) and
//      lo = bf16(p - hi), and each k16 step runs V^T.P_hi^T and
//      V^T.P_lo^T on the same V fragment into the same f32 accumulator:
//      V is exact in bf16, so the product carries p to ~2^-16 relative,
//      the reference's f32 P.V to well under the output's bf16 rounding
//      (one bf16 P would add ~2^-9 relative per weight). l sums the f32
//      p itself; m, l and the accumulator stay f32 in registers. f32:
//      FMAs, HD / 128 rounded up dims a thread;
//   6. merge: the 8 blocks' (m, l, acc) are combined through distributed
//      shared memory after a cluster barrier, each block producing 1/8 of
//      the outputs, in rank order (never arrival order: the bits do not
//      depend on timing), in the same launch, with no partials in device
//      memory and no counters.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace decode {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;            // tokens per work item
constexpr int CL = 8;               // blocks per (row, kv head): one cluster
constexpr int MAX_ITEMS = 256;      // work items per block (64 x 8 x 256 =
                                    // 131072 tokens per row at most)
constexpr int PAD = 8;              // elements of padding per staged row
constexpr int MAX_QPK = 16;         // query heads per kv head, at most
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through L2 only (.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, bf16 in, f32 accumulate; a 16x16 row-major, b 16x8 col-major.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (two 32-bit registers) of an n8 tile of P^T: tokens
// k0 + (lane % 4) * 2 and + 8 of head row `row` (head-major storage).
__device__ __forceinline__ void p_frag(const __nv_bfloat16* row, int k0,
                                       int lane, uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* pr = row + k0 + (lane % 4) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(pr);
  b1 = *reinterpret_cast<const uint32_t*>(pr + 8);
}


// Dynamic shared memory of one block (set above 48 KB per instantiation).
template <typename T, int HD, int NH>
struct Smem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(F32 || NH % 8 == 0, "bf16 pads heads to n8 tiles");
  static constexpr int NQ = NH;             // query heads, padded
  // K/V stages of the ring: 2 in bf16 (~73 KB a block at HD = 128, 3
  // blocks per SM); 1 in f32, whose stage is twice the size
  static constexpr int STAGES = F32 ? 1 : 2;
  alignas(16) T k[STAGES][TILE][HD + PAD];  // K rows; merge: the acc
  alignas(16) T v[STAGES][TILE][HD + PAD];  // V rows
  alignas(16) T p[NQ][TILE + PAD];          // softmax weights (bf16: hi)
  alignas(16) T p_lo[F32 ? 1 : NQ][TILE + PAD];  // bf16: p - hi
  alignas(16) float q[F32 ? NQ : 1][HD];    // f32: staged queries
  int64_t off[STAGES][TILE];                // token row offsets, -1 = skip
  float red_m[WARPS][NQ];                   // per-warp maxima of a tile
  float red_l[WARPS][NQ];                   // per-warp sums of a tile
  float m[NQ], l[NQ];                       // the block's running state
  int live[MAX_ITEMS];                      // items with a token, in order
  uint8_t flag[MAX_ITEMS];                  // scan: item has a token
  int n_live;
};

// The tile's max for head h from the warps' maxima.
template <int NQ>
__device__ __forceinline__ float tile_max(const float (&red)[WARPS][NQ],
                                          int h) {
  float m = red[0][h];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][h]);
  return m;
}

// Step 1: the block's live items (those of rank + CL * j, j < nb, that
// hold an attended token), in item order, in sm.live / sm.n_live.
template <typename T, int HD, int NH, typename Token>
__device__ __forceinline__ void scan_items(Smem<T, HD, NH>& sm, int rank,
                                           int nb, Token& token) {
  constexpr int PER = THREADS / TILE;       // items per pass of the block
  constexpr int UNROLL = 4;                 // passes with loads in flight
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int j = tid; j < nb; j += THREADS) sm.flag[j] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < nb; j0 += PER * UNROLL) {
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + PER * u + tid / TILE;
      ok[u] = j < nb && token((rank + CL * j) * TILE + tid % TILE) >= 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + PER * u + tid / TILE;
      if (__any_sync(FULL, ok[u]) && lane == 0 && j < nb) sm.flag[j] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int nl = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const bool live = b0 + lane < nb && sm.flag[b0 + lane];
      const unsigned bal = __ballot_sync(FULL, live);
      if (live) sm.live[nl + __popc(bal & ((1u << lane) - 1u))] = b0 + lane;
      nl += __popc(bal);
    }
    if (lane == 0) sm.n_live = nl;
  }
  __syncthreads();
}

// Step 2: fill stage `st` with live item `li` of the block (item rank +
// CL * sm.live[li]): offsets first (their loads hit L1 after the scan),
// then the K tile and the V tile as two cp.async groups. Past the live
// list it commits two empty groups, so every refill adds two groups.
template <typename T, int HD, int NH, typename Token>
__device__ __forceinline__ void request(Smem<T, HD, NH>& sm, int st, int li,
                                        int rank, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        Token& token) {
  constexpr int CH = 16 / sizeof(T);       // elements per copy
  constexpr int CPR = HD / CH;             // copies per row
  const int tid = threadIdx.x;
  const bool have = li < sm.n_live;
  if (have) {
    if (tid < TILE)
      sm.off[st][tid] = token((rank + CL * sm.live[li]) * TILE + tid);
    __syncthreads();
  }
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    T(*dst)[HD + PAD] = kv == 0 ? sm.k[st] : sm.v[st];
    const T* src = kv == 0 ? k : v;
    if (have)
      for (int i = tid; i < TILE * CPR; i += THREADS) {
        const int j = i / CPR;
        const int c = (i % CPR) * CH;
        const int64_t o = sm.off[st][j];
        if (o >= 0)
          cp_async16(&dst[j][c], src + o + c);
        else
          *reinterpret_cast<uint4*>(&dst[j][c]) = make_uint4(0, 0, 0, 0);
      }
    cp_async_commit();
  }
}

// Steps 3-4, bf16: warp w scores tokens 16w..16w+15 of stage st against
// the NT n8 tiles of (padded) heads on the tensor cores; qf holds the B
// fragments of Q^T. In tile nt the thread holds tokens t, t + 8 and heads
// 8 nt + h, + 1 of the 16x8 tile. Writes p as a bf16 hi/lo pair and
// returns in alpha the rescale factors of the thread's heads.
template <int HD, int NT>
__device__ __forceinline__ void scores_softmax_mma(
    Smem<__nv_bfloat16, HD, 8 * NT>& sm, int st,
    const uint32_t (&qf)[NT][HD / 16][2], float scale,
    float (&alpha)[NT][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float c[NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, &sm.k[st][warp * 16 + (lane % 16)]
                        [kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(c[nt], a, qf[nt][kk][0],
                                             qf[nt][kk][1]);
  }
  const int t = warp * 16 + lane / 4;
  const bool ok0 = sm.off[st][t] >= 0, ok1 = sm.off[st][t + 8] >= 0;
  float s[NT][4], m[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = ok0 ? c[nt][0] * scale : NEG_INF;
    s[nt][1] = ok0 ? c[nt][1] * scale : NEG_INF;
    s[nt][2] = ok1 ? c[nt][2] * scale : NEG_INF;
    s[nt][3] = ok1 ? c[nt][3] * scale : NEG_INF;
    m[nt][0] = fmaxf(s[nt][0], s[nt][2]);
    m[nt][1] = fmaxf(s[nt][1], s[nt][3]);
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)       // over the warp's tokens
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[nt][i] = fmaxf(m[nt][i], __shfl_xor_sync(FULL, m[nt][i], off));
  if (lane < 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int h = nt * 8 + lane * 2;
      sm.red_m[warp][h] = m[nt][0];
      sm.red_m[warp][h + 1] = m[nt][1];
    }
  __syncthreads();
  float l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int h = nt * 8 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_old = sm.m[h + i];
      m[nt][i] = fmaxf(m_old, tile_max(sm.red_m, h + i));
      alpha[nt][i] = expf(m_old - m[nt][i]);
    }
    const float e[4] = {ok0 ? expf(s[nt][0] - m[nt][0]) : 0.f,
                        ok0 ? expf(s[nt][1] - m[nt][1]) : 0.f,
                        ok1 ? expf(s[nt][2] - m[nt][0]) : 0.f,
                        ok1 ? expf(s[nt][3] - m[nt][1]) : 0.f};
    const int hh[4] = {h, h + 1, h, h + 1}, tt[4] = {t, t, t + 8, t + 8};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const __nv_bfloat16 hi = __float2bfloat16(e[x]);
      sm.p[hh[x]][tt[x]] = hi;
      sm.p_lo[hh[x]][tt[x]] = __float2bfloat16(e[x] - __bfloat162float(hi));
    }
    l[nt][0] = e[0] + e[2];
    l[nt][1] = e[1] + e[3];
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[nt][i] += __shfl_xor_sync(FULL, l[nt][i], off);
  if (lane < 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int h = nt * 8 + lane * 2;
      sm.red_l[warp][h] = l[nt][0];
      sm.red_l[warp][h + 1] = l[nt][1];
    }
}

// Steps 3-4, f32: lanes 2j and 2j+1 of warp w share token 16w + j of
// stage st, each taking every other 4-float chunk of HD; FMAs from shared
// memory over the NH (padded) heads. Returns in alpha the rescale factor
// of every head.
template <int HD, int NH>
__device__ __forceinline__ void scores_softmax_fma(Smem<float, HD, NH>& sm,
                                                   int st, float scale,
                                                   float (&alpha)[NH]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = warp * 16 + lane / 2;
  float s[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) s[h] = 0.f;
#pragma unroll
  for (int d = (lane % 2) * 4; d < HD; d += 8) {
    const float4 kv = *reinterpret_cast<const float4*>(&sm.k[st][t][d]);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float4 qv = *reinterpret_cast<const float4*>(&sm.q[h][d]);
      s[h] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
    }
  }
  const bool ok = sm.off[st][t] >= 0;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    s[h] += __shfl_xor_sync(FULL, s[h], 1);
    s[h] = ok ? s[h] * scale : NEG_INF;
    float m = s[h];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    if (lane == 0) sm.red_m[warp][h] = m;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float m_old = sm.m[h];
    const float m = fmaxf(m_old, tile_max(sm.red_m, h));
    alpha[h] = expf(m_old - m);
    const float e = ok ? expf(s[h] - m) : 0.f;
    if (lane % 2 == 0) sm.p[h][t] = e;
    float l = lane % 2 == 0 ? e : 0.f;
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) l += __shfl_xor_sync(FULL, l, off);
    if (lane == 0) sm.red_l[warp][h] = l;
  }
}

// Step 5, bf16: warp w owns the 16-dim slices w, w + 4, ... of O^T; its
// accumulator fragments c are rescaled by alpha (the thread's heads) and
// the stage's V^T.P_hi^T + V^T.P_lo^T is added on the tensor cores, both
// products on one V fragment per k16 step.
template <int HD, int NT>
__device__ __forceinline__ void pv_mma(Smem<__nv_bfloat16, HD, 8 * NT>& sm,
                                       int st, float (&c)[NT][HD / 64][4],
                                       const float (&alpha)[NT][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;     // ldmatrix: matrix, row
#pragma unroll
  for (int i = 0; i < HD / 64; ++i) {
    const int mt = warp + WARPS * i;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      c[nt][i][0] *= alpha[nt][0];
      c[nt][i][1] *= alpha[nt][1];
      c[nt][i][2] *= alpha[nt][0];
      c[nt][i][3] *= alpha[nt][1];
    }
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, &sm.v[st][ks * 16 + mr + (mi >> 1) * 8]
                                [mt * 16 + (mi & 1) * 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int h = nt * 8 + lane / 4;
        uint32_t b0, b1;
        p_frag(sm.p[h], ks * 16, lane, b0, b1);
        mma_bf16(c[nt][i], a, b0, b1);
        p_frag(sm.p_lo[h], ks * 16, lane, b0, b1);
        mma_bf16(c[nt][i], a, b0, b1);
      }
    }
  }
}

// Step 5, f32: thread d owns dims d, d + THREADS, ... (< HD) of every
// (padded) head, tokens in order.
template <int HD, int NH>
__device__ __forceinline__ void pv_fma(
    Smem<float, HD, NH>& sm, int st,
    float (&a)[NH][(HD + THREADS - 1) / THREADS], const float (&alpha)[NH]) {
  constexpr int DPT = (HD + THREADS - 1) / THREADS;
#pragma unroll
  for (int u = 0; u < DPT; ++u) {
    const int d = threadIdx.x + u * THREADS;
    if (d >= HD) break;
#pragma unroll
    for (int h = 0; h < NH; ++h) a[h][u] *= alpha[h];
#pragma unroll 8
    for (int t = 0; t < TILE; ++t) {
      const float vv = sm.v[st][t][d];
#pragma unroll
      for (int h = 0; h < NH; ++h) a[h][u] += sm.p[h][t] * vv;
    }
  }
}

// The block's share of work of (row, kv group g): block (rank, g, row) of
// a grid whose x extent is CL, one cluster. `token(t)` returns the
// element offset of token t's K (= V) head row, or -1 when the token is
// not attended; `n` is the row's number of items; the group has qpk <=
// NH query heads. Writes the group's qpk output rows of `out` (B, H *
// HD).
template <typename T, int HD, int NH, typename Token>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const uint8_t* __restrict__ active,
                                       T* __restrict__ out, int n, int H,
                                       int qpk, float scale, Token token) {
  using S = Smem<T, HD, NH>;
  constexpr bool F32 = S::F32;
  constexpr int NQ = NH;
  constexpr int NT = NH >= 8 ? NH / 8 : 1;            // bf16 n8 tiles
  constexpr int DPT = (HD + THREADS - 1) / THREADS;   // f32 dims a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const T* qg = q + ((int64_t)row * H + g * qpk) * HD;
  T* out_g = out + ((int64_t)row * H + g * qpk) * HD;
  const bool act = active[row] != 0;   // in flight with the scan's loads
  uint32_t qf[NT][HD / 16][2];         // bf16: B fragments of Q^T
  if constexpr (F32) {                 // padded heads: zero queries
    for (int i = tid; i < NQ * HD; i += THREADS)
      sm.q[i / HD][i % HD] = i < qpk * HD ? qg[i] : 0.f;
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int hq = nt * 8 + lane / 4;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const T* qp = qg + hq * HD + kk * 16 + (lane % 4) * 2;
        qf[nt][kk][0] =
            hq < qpk ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
        qf[nt][kk][1] =
            hq < qpk ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
      }
    }
  }
  if (tid < NQ) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  const int nb = rank < n ? (n - rank + CL - 1) / CL : 0;
  scan_items(sm, rank, nb, token);
  if (!act) {                          // the whole cluster exits
    if (rank == 0)
      for (int o = tid; o < qpk * HD; o += THREADS) out_g[o] = from_f<T>(0.f);
    return;
  }
  // rescale factors a thread applies, and its accumulator
  std::conditional_t<F32, float[NQ], float[NT][2]> alpha;
  std::conditional_t<F32, float[NQ][DPT], float[NT][HD / 64][4]> acc = {};
  constexpr int STAGES = S::STAGES;
  for (int s = 0; s < STAGES; ++s) request(sm, s, s, rank, k, v, token);
  for (int li = 0; li < sm.n_live; ++li) {
    const int st = li % STAGES;
    cp_async_wait<2 * STAGES - 1>();   // this item's K tile has landed
    __syncthreads();
    if constexpr (F32)
      scores_softmax_fma<HD, NH>(sm, st, scale, alpha);
    else
      scores_softmax_mma<HD, NT>(sm, st, qf, scale, alpha);
    cp_async_wait<2 * STAGES - 2>();   // and its V tile
    __syncthreads();
    if (tid < qpk) {                   // sm.m is read by no one until the
      const float m_old = sm.m[tid];   // next item's scores
      const float m_new = fmaxf(m_old, tile_max(sm.red_m, tid));
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += sm.red_l[w][tid];
      sm.l[tid] = sm.l[tid] * expf(m_old - m_new) + l;
      sm.m[tid] = m_new;
    }
    if constexpr (F32)
      pv_fma<HD, NH>(sm, st, acc, alpha);
    else
      pv_mma<HD, NT>(sm, st, acc, alpha);
    __syncthreads();                   // stage st is consumed: refill it
    request(sm, st, li + STAGES, rank, k, v, token);
  }
  cp_async_wait<0>();
  __syncthreads();
  // Step 6. The block's acc, f32 [qpk][HD], over its K stages.
  float(&accs)[NQ][HD] = *reinterpret_cast<float(*)[NQ][HD]>(&sm.k[0][0][0]);
  static_assert(sizeof(float) * NQ * HD <= sizeof(sm.k), "acc staging");
  if constexpr (F32) {
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int d = tid + u * THREADS;
      if (d < HD)
#pragma unroll
        for (int h = 0; h < NQ; ++h) accs[h][d] = acc[h][u];
    }
  } else {
    const int warp = tid / 32;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int h = nt * 8 + (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < HD / 64; ++i) {
        const int d = (warp + WARPS * i) * 16 + lane / 4;
        if (h < qpk) {
          accs[h][d] = acc[nt][i][0];
          accs[h][d + 8] = acc[nt][i][2];
        }
        if (h + 1 < qpk) {
          accs[h + 1][d] = acc[nt][i][1];
          accs[h + 1][d + 8] = acc[nt][i][3];
        }
      }
    }
  }
  cluster.sync();                      // every block's state is in place
  for (int o = rank * THREADS + tid; o < qpk * HD; o += CL * THREADS) {
    const int h = o / HD, d = o % HD;
    float mr[CL], lr[CL], ar[CL];      // every rank's state, loads batched
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      const S* rs = cluster.map_shared_rank(&sm, r);
      mr[r] = rs->m[h];
      lr[r] = rs->l[h];
      ar[r] = (*reinterpret_cast<const float(*)[NQ][HD]>(
          &rs->k[0][0][0]))[h][d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < CL; ++r) mx = fmaxf(mx, mr[r]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) {     // in rank order
      if (lr[r] > 0.f) {               // a block with no token drops out
        const float w = expf(mr[r] - mx);
        l += lr[r] * w;
        a += w * ar[r];
      }
    }
    out_g[o] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();                      // no block leaves while read
}

// Call f(T{}, integral_constant<HD>, integral_constant<NH>) for the
// instantiation that serves (dtype, hd, qpk): dtype 0 = float32, 1 =
// bfloat16; hd 64, 128 or 192; qpk 1-16 padded to NH = 8 or 16 in bf16,
// 4, 8 or 16 in f32. cudaErrorInvalidValue for an unsupported shape.
template <typename F>
cudaError_t dispatch(int dtype, int hd, int qpk, F&& f) {
  if (qpk < 1 || qpk > MAX_QPK) return cudaErrorInvalidValue;
  auto by_nt = [&](auto t, auto d) -> cudaError_t {
    if constexpr (std::is_same<decltype(t), float>::value) {
      if (qpk <= 4) return f(t, d, std::integral_constant<int, 4>{});
    }
    if (qpk <= 8) return f(t, d, std::integral_constant<int, 8>{});
    return f(t, d, std::integral_constant<int, 16>{});
  };
  auto by_hd = [&](auto t) -> cudaError_t {
    switch (hd) {
      case 64: return by_nt(t, std::integral_constant<int, 64>{});
      case 128: return by_nt(t, std::integral_constant<int, 128>{});
      case 192: return by_nt(t, std::integral_constant<int, 192>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_hd(float{});
  if (dtype == 1) return by_hd(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// The query heads per kv head of an (H, Hkv) pair, or 0 when H is not a
// multiple of Hkv.
inline int q_per_kv(int H, int Hkv) {
  return Hkv > 0 && H % Hkv == 0 ? H / Hkv : 0;
}

// The wrapper's item count must be the one this build derives from the
// row's extent (S, or NB * BS), and fit MAX_ITEMS per block: a wrapper
// whose TILE, CL or MAX_ITEMS disagree with these is refused here.
inline bool items_ok(int n_items, int extent) {
  const int want = extent > TILE ? (extent + TILE - 1) / TILE : 1;
  return n_items == want && (n_items + CL - 1) / CL <= MAX_ITEMS;
}

// Launch `kernel` in clusters of CL blocks along x, with Smem<T, HD, NH>
// of dynamic shared memory. The function's shared-memory limit (above 48
// KB) belongs to the current device, so it is raised once per
// instantiation and device. `launch` has internal linkage, so the record
// of that stays in this library even where another one holds the same
// instantiation.
template <typename T, int HD, int NH, typename... KArgs, typename... Args>
static cudaError_t launch(void (*kernel)(KArgs...), dim3 grid,
                          cudaStream_t stream, Args... args) {
  constexpr int smem = sizeof(Smem<T, HD, NH>);
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> raised[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !raised[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) raised[dev].store(true, std::memory_order_release);
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

}  // namespace decode

// Message for an error code a *_launch function returned.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block of the instantiation that serves
// (dtype, hd, qpk) (0 if there is none), for the build report.
extern "C" int decode_smem_bytes(int dtype, int hd, int qpk) {
  int bytes = 0;
  decode::dispatch(dtype, hd, qpk, [&](auto t, auto d, auto nh) {
    bytes = sizeof(decode::Smem<decltype(t), decltype(d)::value,
                                decltype(nh)::value>);
    return cudaSuccess;
  });
  return bytes;
}
