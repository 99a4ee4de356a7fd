// One fused Lloyd step: distances → argmin → per-cluster sums, counts and the
// objective, from ONE read of a tall row-major X (n, p) against centers C (k, p).
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py:_kernel.  The TPU
// grid walked row blocks in order with sums/counts/wss in VMEM.  Two bodies
// share the owner gather and the combine: the TMA body (lloyd_tma_partials,
// p ≤ 32 in rows of a multiple of 16 bytes: f32 p ∈ {4, 8, …, 32}, bf16
// p ∈ {8, 16, 24, 32}; the main path; its note is further down) and the
// staged body described here, which takes every other shape:
//
//   launch 1 (center_norms): ‖c‖² of every center, once, into the workspace.
//   launch 2 (lloyd_partials): a persistent grid of blocks walks chunks of 256
//     rows.  The centers and ‖c‖² are staged in (dynamic) shared memory once
//     per block — each is read from global memory instead when it would not
//     leave room for the row tile.  A chunk of X is contiguous, so it is
//     staged with coalesced loads into a shared tile (odd row stride: no bank
//     conflicts when thread r reads row r).  Thread r then computes
//     D = ‖x‖² − 2·x·c + ‖c‖² for every center by the reference's expansion
//     (kernels/kmeans_assign.py:48-52), keeps the first index on ties, writes
//     the label as int32 and adds its min D to a register.  Cluster sums and
//     counts are then gathered by OWNER threads: thread (lane s, column j)
//     adds rows s, s + L, ... of the chunk into its own slab of per-lane
//     partials in shared memory, (lane, cluster, column), so there are no
//     atomics and the order is fixed.  At the end the lanes are summed in
//     order into the block's partial, and wss is reduced in a fixed tree.
//     (When the partials do not fit, one lane accumulates in the workspace.)
//   launch 3 (lloyd_combine): sums, counts and wss of all blocks, in block
//     order.
//
// Bound: the read of X (and the label write); k·p FMAs per row are far below
// the card's f32 rate at k, p ≤ 64.  Offsets are 64-bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper_async.cuh"  // mbar_*, tma_load, encoder

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int THREADS = 256;
constexpr int R = THREADS;  // rows per chunk, one per thread

__device__ __forceinline__ float load_f(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

struct Layout {
  int c_smem, x_smem, c2_smem, part_smem;
  int x_stride;  // odd row stride of the shared row tile
  int lanes;     // row lanes of the shared sum partials
};

__global__ void center_norms(const float* __restrict__ cg, float* __restrict__ c2g,
                             int p, int k) {
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  if (kk >= k) return;
  float s = 0.f;
  for (int j = 0; j < p; ++j) s = fmaf(cg[kk * p + j], cg[kk * p + j], s);
  c2g[kk] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lloyd_partials(const T* __restrict__ x, const float* __restrict__ cg,
               const float* __restrict__ c2g,
               int* __restrict__ labels, float* __restrict__ ws_sums,
               float* __restrict__ ws_cnt, float* __restrict__ ws_wss,
               int64_t n, int p, int k, Layout lay) {
  extern __shared__ float smem[];
  const int kp = k * p;
  const int L = lay.lanes;
  float* c2 = smem;                                     // k       (c2_smem)
  float* cs = c2 + (lay.c2_smem ? k : 0);               // k·p     (c_smem)
  float* xs = cs + (lay.c_smem ? kp : 0);               // R·stride (x_smem)
  float* psum_s = xs + (lay.x_smem ? R * lay.x_stride : 0);  // L·k·p (part_smem)
  float* pcnt_s = psum_s + (lay.part_smem ? L * kp : 0);     // L·k   (part_smem)
  int* lab_s = reinterpret_cast<int*>(pcnt_s + (lay.part_smem ? L * k : 0));
  float* red = reinterpret_cast<float*>(lab_s + R);     // THREADS

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  float* my_sums = ws_sums + b * kp;
  float* my_cnt = ws_cnt + b * k;
  // Sum partials: in shared memory, one slab per row lane; else the block's
  // workspace slice with a single lane.
  float* psum = lay.part_smem ? psum_s : my_sums;
  float* pcnt = lay.part_smem ? pcnt_s : my_cnt;
  for (int o = tid; o < L * kp; o += THREADS) psum[o] = 0.f;
  for (int o = tid; o < L * k; o += THREADS) pcnt[o] = 0.f;
  if (lay.c_smem)
    for (int o = tid; o < kp; o += THREADS) cs[o] = cg[o];
  if (lay.c2_smem)
    for (int kk = tid; kk < k; kk += THREADS) c2[kk] = c2g[kk];
  __syncthreads();
  const float* cp = lay.c_smem ? cs : cg;
  const float* c2p = lay.c2_smem ? c2 : c2g;
  // This thread's (row lane, first column) in the gather: lane s takes rows
  // s, s + L, ...; columns j0, j0 + jstep, ... (one column when p ≤ THREADS).
  const int s_lane = p <= THREADS ? tid / p : 0;
  const int j0 = p <= THREADS ? tid % p : tid;
  const int jstep = p <= THREADS ? p : THREADS;
  const bool gathers = s_lane < L;

  float wss = 0.f;
  const int64_t n_chunks = (n + R - 1) / R;
  for (int64_t chunk = b; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * R;
    const int rows = (int)min64((int64_t)R, n - r0);
    const int64_t base = r0 * (int64_t)p;
    if (lay.x_smem) {
      const int total = rows * p;
      for (int e = tid; e < total; e += THREADS)
        xs[(e / p) * lay.x_stride + (e % p)] = load_f(x, base + e);
      __syncthreads();
    }
    int lab = -1;
    if (tid < rows) {
      float x2 = 0.f;
      for (int j = 0; j < p; ++j) {
        const float v = lay.x_smem ? xs[tid * lay.x_stride + j]
                                   : load_f(x, base + (int64_t)tid * p + j);
        x2 = fmaf(v, v, x2);
      }
      float best = INFINITY;
      lab = 0;
      for (int kk = 0; kk < k; ++kk) {
        float dot = 0.f;
        for (int j = 0; j < p; ++j) {
          const float v = lay.x_smem ? xs[tid * lay.x_stride + j]
                                     : load_f(x, base + (int64_t)tid * p + j);
          dot = fmaf(v, cp[kk * p + j], dot);
        }
        // (x2 - 2·dot) + c2, rounded as written (no contraction).
        const float d = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot)), c2p[kk]);
        if (d < best) { best = d; lab = kk; }
      }
      labels[r0 + tid] = lab;
      wss += best;
    }
    lab_s[tid] = lab;
    __syncthreads();
    // Gather: every (lane, column) entry belongs to one thread, which adds
    // its rows in row order — no atomics, a fixed order.
    if (gathers) {
      for (int j = j0; j < p; j += jstep) {
        for (int rr = s_lane; rr < rows; rr += L) {
          const float v = lay.x_smem ? xs[rr * lay.x_stride + j]
                                     : load_f(x, base + (int64_t)rr * p + j);
          psum[(s_lane * k + lab_s[rr]) * p + j] += v;
        }
      }
      if (j0 == 0) {
        for (int rr = s_lane; rr < rows; rr += L) pcnt[s_lane * k + lab_s[rr]] += 1.f;
      }
    }
    __syncthreads();
  }

  if (lay.part_smem) {  // lanes → the block's partial, in lane order
    for (int o = tid; o < kp; o += THREADS) {
      float v = 0.f;
      for (int sl = 0; sl < L; ++sl) v += psum[sl * kp + o];
      my_sums[o] = v;
    }
    for (int kk = tid; kk < k; kk += THREADS) {
      float v = 0.f;
      for (int sl = 0; sl < L; ++sl) v += pcnt[sl * k + kk];
      my_cnt[kk] = v;
    }
  }
  red[tid] = wss;
  __syncthreads();
  for (int st = THREADS / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) ws_wss[b] = red[0];
}

__global__ void lloyd_combine(const float* __restrict__ ws_sums,
                              const float* __restrict__ ws_cnt,
                              const float* __restrict__ ws_wss,
                              float* __restrict__ sums, float* __restrict__ cnts,
                              float* __restrict__ wss, int kp, int k, int blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (e < kp) {
    for (int b = 0; b < blocks; ++b) s += ws_sums[(int64_t)b * kp + e];
    sums[e] = s;
  } else if (e < kp + k) {
    const int kk = e - kp;
    for (int b = 0; b < blocks; ++b) s += ws_cnt[(int64_t)b * k + kk];
    cnts[kk] = s;
  } else if (e == kp + k) {
    for (int b = 0; b < blocks; ++b) s += ws_wss[b];
    wss[0] = s;
  }
}

template <typename T>
int launch(const void* x, const void* c, void* labels, void* ws, void* sums,
           void* cnts, void* wss, int64_t n, int p, int k, int blocks,
           int smem_limit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Layout lay;
  lay.x_stride = (p % 2 == 1) ? p : p + 1;
  const size_t lim = (size_t)smem_limit;
  size_t used = (size_t)R * 4 + (size_t)THREADS * 4;  // labels + reduction
  lay.c2_smem = used + (size_t)k * 4 <= lim;
  if (lay.c2_smem) used += (size_t)k * 4;
  const size_t xbytes = (size_t)R * lay.x_stride * 4;
  lay.x_smem = used + xbytes <= lim;
  if (lay.x_smem) used += xbytes;
  lay.lanes = p <= THREADS ? THREADS / p : 1;
  const size_t pbytes = (size_t)lay.lanes * k * (p + 1) * 4;
  lay.part_smem = used + pbytes <= lim;
  if (lay.part_smem) used += pbytes;
  else lay.lanes = 1;  // partials in the workspace: one lane per block
  lay.c_smem = used + (size_t)k * p * 4 <= lim;
  if (lay.c_smem) used += (size_t)k * p * 4;
  if (used > lim) return (int)cudaErrorInvalidValue;
  auto kern = lloyd_partials<T>;
  if (used > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)used);
    if (e != cudaSuccess) return (int)e;
  }
  float* wsf = static_cast<float*>(ws);
  float* ws_sums = wsf;
  float* ws_cnt = ws_sums + (int64_t)blocks * k * p;
  float* ws_wss = ws_cnt + (int64_t)blocks * k;
  float* ws_c2 = ws_wss + blocks;
  const float* cf = static_cast<const float*>(c);
  center_norms<<<(k + 255) / 256, 256, 0, st>>>(cf, ws_c2, p, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, used, st>>>(
      static_cast<const T*>(x), cf, ws_c2,
      static_cast<int*>(labels), ws_sums, ws_cnt, ws_wss, n, p, k, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = k * p + k + 1;
  lloyd_combine<<<(total + 255) / 256, 256, 0, st>>>(
      ws_sums, ws_cnt, ws_wss, static_cast<float*>(sums),
      static_cast<float*>(cnts), static_cast<float*>(wss), k * p, k, blocks);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The TMA body (lloyd_tma_partials): p ≤ 32 and rows of PB = p·elem bytes, a
// multiple of 16 up to 128 (the main path: Friendster-32, p = 32 f32, k = 10).
// Its bound is reading X and writing the labels (8.66 GB, 2.59 ms at 3.35
// TB/s); the staged body missed it 4.5× — a runtime divide and modulo per
// staged element, few loads in flight, the memory idle while a block
// computed, and 4–5 instructions an FMA re-reading x and the center from
// shared memory.  Here
//   * a 2-D tensor map (p columns × n rows, 128-byte swizzle) feeds boxes of
//     256 rows, one a chunk, into an mbarrier ring of `stages` stages: thread
//     0 refills a stage once the block is done with it, so stages − 1 chunks
//     are in flight while one is computed (two blocks an SM at k = 10), and
//     no register holds a load.  TMA fills rows past n with zeros; they are
//     masked out of labels, sums, counts and wss;
//   * under the 128-byte swizzle TMA lays every row at a 128-byte pitch (a
//     narrower row is padded: measured on the H100, PERF.md), piece q of row
//     r at piece q ^ (r & 7), the stages on 1024-byte boundaries.  Thread r
//     of a chunk takes row r and reads it once into registers as 16-byte
//     pieces: the 8 threads of a quarter-warp hit 8 different bank groups;
//   * every thread needs the same piece of the same center at once, so each
//     center read is a broadcast; KB = 2 centers' dot products run together
//     from one register copy of x (k padded with a zero center when odd),
//     each summed over j in order;
//     D = (‖x‖² − 2·x·c) + ‖c‖² is rounded as written, first index on ties;
//   * ‖c‖² is computed by the block from its shared copy of the centers (no
//     launch of its own);
//   * sums and counts: an owner gather — thread (lane s, columns j .. j + 3)
//     adds rows s, s + L, … in row order into its own slab, one 16-byte piece
//     a row read through the same swizzle, so a warp adds 8 / (p / 4) rows
//     an instruction; the slabs live in shared memory when they fit (a
//     template parameter, so they are addressed as shared, not generic),
//     else one lane in the block's workspace.  Block partials and
//     lloyd_combine in block order: no atomics, deterministic.
// Geometry (stages, blocks, lanes, where the partials live) is
// kmeans_assign.py's lloyd_plan, a function of (n, p, k, dtype) alone.
constexpr int TMA_ROWS = 256;   // rows of a box and of a chunk: one a thread
constexpr int TMA_PITCH = 128;  // shared bytes a staged row (the swizzle's span)
constexpr int KB = 2;           // centers whose dot products run together
constexpr int GC = 4;           // columns a gather thread adds
constexpr int TMA_BARS = 64;    // one mbarrier a stage (≤ 8)

struct TmaLayout {
  int stages;     // ring stages of TMA_ROWS·TMA_PITCH bytes
  int lanes;      // row lanes of the sum partials
  int part_smem;  // partials in shared memory (else the block's workspace, one lane)
};

// Byte offset in a stage of byte b of row r under the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return (uint32_t)(r * TMA_PITCH + (b ^ ((r & 7) << 4)));
}

// Piece q (16 bytes) of staged row r, widened to f32.
__device__ __forceinline__ void piece(const unsigned char* st, int r, int q, float* v,
                                      float) {
  const float4 f = *reinterpret_cast<const float4*>(st + swz(r, 16 * q));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void piece(const unsigned char* st, int r, int q, float* v,
                                      __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(st + swz(r, 16 * q));
  const unsigned h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // element 2e is the low half
    v[2 * e] = __uint_as_float(h[e] << 16);
    v[2 * e + 1] = __uint_as_float(h[e] & 0xffff0000u);
  }
}
// Columns j .. j + 3 of staged row r (j a multiple of 4), widened.
__device__ __forceinline__ float4 four(const unsigned char* st, int r, int j, float) {
  return *reinterpret_cast<const float4*>(st + swz(r, 4 * j));
}
__device__ __forceinline__ float4 four(const unsigned char* st, int r, int j,
                                       __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(st + swz(r, 2 * j));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Shared bytes of a TMA block (kmeans_assign.py tma_smem says the same):
// 1024 to put the ring on the swizzle's period, the ring, the barriers, the
// lanes' partials when they are in shared memory, the centers and ‖c‖² (k
// rounded up to KB), labels and the wss reduction.
int64_t tma_smem(int p, int k, const TmaLayout& lay) {
  const int64_t k2 = (k + KB - 1) / KB * KB;
  int64_t b = 1024 + (int64_t)lay.stages * TMA_ROWS * TMA_PITCH + TMA_BARS;
  if (lay.part_smem) b += (int64_t)lay.lanes * k * (p + 1) * 4;
  return b + (k2 * p + k2) * 4 + 2 * TMA_ROWS * 4;
}

template <typename T, int NQ, bool PART_SMEM>
__global__ void __launch_bounds__(THREADS, 2)
lloyd_tma_partials(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ cg,
                   int* __restrict__ labels, float* __restrict__ ws_sums,
                   float* __restrict__ ws_cnt, float* __restrict__ ws_wss, int64_t n,
                   int k, TmaLayout lay) {
  constexpr int PB = NQ * 16;                    // bytes a row in global memory
  constexpr int P = PB / (int)sizeof(T);         // columns
  constexpr int PER = 16 / (int)sizeof(T);       // columns a piece
  constexpr int SB = TMA_ROWS * TMA_PITCH;       // shared bytes a stage
  constexpr int TX = TMA_ROWS * PB;              // bytes a box brings
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int S = lay.stages, L = lay.lanes;
  const int k2 = (k + KB - 1) / KB * KB, kp = k * P;
  const uint32_t bars = ring + (uint32_t)S * SB;
  float* psum_s = reinterpret_cast<float*>(sm + S * SB + TMA_BARS);  // L·k·P
  float* cs = psum_s + (PART_SMEM ? L * kp : 0);                      // k2·P
  float* c2 = cs + k2 * P;                                            // k2
  float* pcnt_s = c2 + k2;                                            // L·k
  int* lab_s = reinterpret_cast<int*>(pcnt_s + (PART_SMEM ? L * k : 0));  // TMA_ROWS
  float* red = reinterpret_cast<float*>(lab_s + TMA_ROWS);           // THREADS

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x, G = gridDim.x;
  const int64_t n_chunks = (n + TMA_ROWS - 1) / TMA_ROWS;
  const int mine = b < n_chunks ? (int)((n_chunks - b + G - 1) / G) : 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    for (int i = 0; i < min(S, mine); ++i) {
      mbar_expect_tx(bars + 8 * i, TX);
      tma_load(ring + (uint32_t)i * SB, &xmap, bars + 8 * i, 0,
               (int)((b + i * G) * TMA_ROWS));
    }
  }
  float* my_sums = ws_sums + b * kp;
  float* my_cnt = ws_cnt + b * k;
  float* psum = PART_SMEM ? psum_s : my_sums;
  float* pcnt = PART_SMEM ? pcnt_s : my_cnt;
  for (int o = tid; o < L * kp; o += THREADS) psum[o] = 0.f;
  for (int o = tid; o < L * k; o += THREADS) pcnt[o] = 0.f;
  for (int o = tid; o < k2 * P; o += THREADS) cs[o] = o < kp ? cg[o] : 0.f;
  __syncthreads();
  for (int kk = tid; kk < k2; kk += THREADS) {
    float s = 0.f;
    for (int j = 0; j < P; ++j) s = fmaf(cs[kk * P + j], cs[kk * P + j], s);
    c2[kk] = s;
  }
  __syncthreads();
  // This thread's (row lane, first column) in the gather: lane s takes rows
  // s, s + L, ... of columns j0 .. j0 + GC - 1.
  const int s_lane = tid / (P / GC), j0 = tid % (P / GC) * GC;
  const bool gathers = s_lane < L;

  float wss = 0.f;
  for (int i = 0; i < mine; ++i) {
    const int s = i % S;
    const int64_t r0 = (b + i * G) * TMA_ROWS;
    const int rows = (int)min64((int64_t)TMA_ROWS, n - r0);
    mbar_wait(bars + 8 * s, (uint32_t)(i / S) & 1u);
    const unsigned char* st = sm + s * SB;
    int lab = -1;
    if (tid < rows) {
      float x[P];
#pragma unroll
      for (int q = 0; q < NQ; ++q) piece(st, tid, q, x + q * PER, T());
      float x2 = 0.f;
#pragma unroll
      for (int jj = 0; jj < P; ++jj) x2 = fmaf(x[jj], x[jj], x2);
      float best = INFINITY;
      lab = 0;
      for (int kk0 = 0; kk0 < k; kk0 += KB) {
        float dot[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) dot[u] = 0.f;
#pragma unroll
        for (int jj = 0; jj < P; jj += 4) {
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            const float4 c = *reinterpret_cast<const float4*>(cs + (kk0 + u) * P + jj);
            dot[u] = fmaf(x[jj], c.x, dot[u]);
            dot[u] = fmaf(x[jj + 1], c.y, dot[u]);
            dot[u] = fmaf(x[jj + 2], c.z, dot[u]);
            dot[u] = fmaf(x[jj + 3], c.w, dot[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          // (x2 - 2·dot) + c2, rounded as written (no contraction).
          const float d = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot[u])), c2[kk0 + u]);
          if (kk0 + u < k && d < best) {
            best = d;
            lab = kk0 + u;
          }
        }
      }
      labels[r0 + tid] = lab;
      wss += best;
    }
    lab_s[tid] = lab;
    __syncthreads();
    // Gather: every (lane, columns) entry belongs to one thread, which adds
    // its rows in row order — no atomics, a fixed order.
    if (gathers) {
      for (int rr = s_lane; rr < rows; rr += L) {
        const int l = lab_s[rr];
        const float4 v = four(st, rr, j0, T());
        float4* d = reinterpret_cast<float4*>(psum + (s_lane * k + l) * P + j0);
        float4 a = *d;
        a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
        *d = a;
        if (j0 == 0) pcnt[s_lane * k + l] += 1.f;
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + S < mine) {
      mbar_expect_tx(bars + 8 * s, TX);
      tma_load(ring + (uint32_t)s * SB, &xmap, bars + 8 * s, 0,
               (int)((b + (i + S) * G) * TMA_ROWS));
    }
  }

  if (PART_SMEM) {  // lanes → the block's partial, in lane order
    for (int o = tid; o < kp; o += THREADS) {
      float v = 0.f;
      for (int sl = 0; sl < L; ++sl) v += psum[sl * kp + o];
      my_sums[o] = v;
    }
    for (int kk = tid; kk < k; kk += THREADS) {
      float v = 0.f;
      for (int sl = 0; sl < L; ++sl) v += pcnt[sl * k + kk];
      my_cnt[kk] = v;
    }
  }
  red[tid] = wss;
  __syncthreads();
  for (int st = THREADS / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) ws_wss[b] = red[0];
}

template <typename T, int NQ>
int launch_tma_t(const void* x, const void* c, void* labels, void* ws, void* sums,
                 void* cnts, void* wss, int64_t n, int k, int blocks,
                 const TmaLayout& lay, cudaStream_t st) {
  constexpr int PB = NQ * 16, P = PB / (int)sizeof(T);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)P, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)PB};
  const cuuint32_t box[2] = {(cuuint32_t)P, (cuuint32_t)TMA_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(&map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = tma_smem(P, k, lay);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  auto kern = lay.part_smem ? lloyd_tma_partials<T, NQ, true>
                            : lloyd_tma_partials<T, NQ, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* ws_sums = static_cast<float*>(ws);
  float* ws_cnt = ws_sums + (int64_t)blocks * k * P;
  float* ws_wss = ws_cnt + (int64_t)blocks * k;
  kern<<<blocks, THREADS, smem, st>>>(map, static_cast<const float*>(c),
                                      static_cast<int*>(labels), ws_sums, ws_cnt, ws_wss,
                                      n, k, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = k * P + k + 1;
  lloyd_combine<<<(total + 255) / 256, 256, 0, st>>>(
      ws_sums, ws_cnt, ws_wss, static_cast<float*>(sums), static_cast<float*>(cnts),
      static_cast<float*>(wss), k * P, k, blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tma(const void* x, const void* c, void* labels, void* ws, void* sums,
               void* cnts, void* wss, int64_t n, int p, int k, int blocks,
               const TmaLayout& lay, cudaStream_t st) {
  const int pb = p * (int)sizeof(T);
  if (pb % 16 != 0 || p < 1 || p > 32 || n < 1 || n > INT32_MAX || k < 1 ||
      blocks < 1 || lay.stages < 1 || lay.stages > TMA_BARS / 8 || lay.lanes < 1 ||
      lay.lanes * (p / GC) > THREADS || (!lay.part_smem && lay.lanes != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (pb / 16) {
#define FM_NQ(q)                                                                     \
  case q:                                                                            \
    if constexpr (q * 16 / sizeof(T) <= 32)                                          \
      return launch_tma_t<T, q>(x, c, labels, ws, sums, cnts, wss, n, k, blocks, lay, \
                                st);                                                 \
    break;
    FM_NQ(1) FM_NQ(2) FM_NQ(3) FM_NQ(4) FM_NQ(5) FM_NQ(6) FM_NQ(7) FM_NQ(8)
#undef FM_NQ
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (n, p) float32 (dtype 0) or bfloat16 (dtype 1); c: (k, p) float32.
// ws holds blocks·(k·p + k + 1) + k floats.  smem_limit: dynamic shared memory a
// block may use, in bytes.
int fm_kmeans_assign(const void* x, const void* c, void* labels, void* ws,
                     void* sums, void* cnts, void* wss, int64_t n, int p, int k,
                     int blocks, int smem_limit, int dtype, void* stream) {
  return dtype == 0
      ? launch<float>(x, c, labels, ws, sums, cnts, wss, n, p, k, blocks,
                      smem_limit, stream)
      : launch<__nv_bfloat16>(x, c, labels, ws, sums, cnts, wss, n, p, k, blocks,
                              smem_limit, stream);
}

// The TMA body: x (n, p) float32 (dtype 0) or bfloat16 (dtype 1), 16-byte
// aligned, p ≤ 32 with p·elem a multiple of 16, 1 ≤ n < 2^31; c (k, p)
// float32.  ws holds blocks·(k·p + k + 1) floats.  stages, lanes and
// part_smem from kmeans_assign.py lloyd_plan.
int fm_kmeans_assign_tma(const void* x, const void* c, void* labels, void* ws,
                         void* sums, void* cnts, void* wss, int64_t n, int p, int k,
                         int blocks, int stages, int lanes, int part_smem, int dtype,
                         void* stream) {
  const TmaLayout lay{stages, lanes, part_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? launch_tma<float>(x, c, labels, ws, sums, cnts, wss, n, p, k, blocks, lay, st)
      : launch_tma<__nv_bfloat16>(x, c, labels, ws, sums, cnts, wss, n, p, k, blocks,
                                  lay, st);
}

}  // extern "C"
