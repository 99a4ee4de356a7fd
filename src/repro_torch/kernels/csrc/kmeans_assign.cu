// One fused Lloyd step: distances → argmin → per-cluster sums, counts and the
// objective, from ONE read of a tall row-major X (n, p) against centers C (k, p).
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py:_kernel.  The TPU
// grid walked row blocks in order with sums/counts/wss in VMEM; here
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

}  // extern "C"
