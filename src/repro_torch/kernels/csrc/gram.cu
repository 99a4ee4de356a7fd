// G = XᵀX (gram) and G = XᵀWX (wgram) for a tall row-major X (n, p).
//
// Replaces the Pallas kernels repro/kernels/gram.py:_gram_kernel and
// repro/kernels/weighted_gram.py:_wgram_kernel.  The TPU grid walked the row
// blocks in order and kept one (p, p) accumulator in VMEM; here the n rows are
// split over many blocks that run in parallel:
//
//   launch 1 (fm_gram_partials): grid (tiles, tiles, splits).  Block (ti, tj, s)
//     computes the 32×32 output tile (ti, tj) over its row range: rows are
//     staged through shared memory in chunks of CH rows (the left tile's
//     columns multiplied by w on the way in for wgram; bf16 widened to f32 on
//     load; the next chunk already loading into registers while this one is
//     computed), and each of the 256 threads keeps a 4×4 register tile of
//     the sum.
//     The four row lanes of a block are reduced in shared memory in a fixed
//     order and the block's partial tile goes to the workspace.
//   launch 2 (fm_tile_reduce): one thread per output element sums the splits'
//     partials in split order.  Results are deterministic: no atomics.
//
// Ragged n and p are masked while staging (zero rows and columns are neutral
// for a sum of products), so X is never padded or copied.  Offsets are 64-bit:
// n·p reaches 2^31 at the sizes this runs at.  Plain f32 FMA, no tensor
// cores: the reference tests hold f32 at 1e-4.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int TILE = 32;   // output tile edge
constexpr int CH = 64;     // rows staged per chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* x, int64_t i) { return x[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

// Load one chunk's share of this thread: rows r0.. of the left (i0) and
// right (j0) column tiles, zero past the row range or the last column; the
// left value carries the row weight for wgram.
template <typename T, bool WEIGHTED, int PER>
__device__ __forceinline__ void fetch_chunk(const T* __restrict__ x,
                                            const float* __restrict__ w,
                                            int64_t r0, int64_t r_end, int p,
                                            int i0, int j0, int tid,
                                            float (&nl)[PER], float (&nr)[PER]) {
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS;
    const int rr = e / TILE, cc = e % TILE;
    const int64_t r = r0 + rr;
    float lv = 0.f, rv = 0.f;
    if (r < r_end) {
      const int64_t base = r * (int64_t)p;
      if (i0 + cc < p) lv = load_f(x, base + i0 + cc);
      if (i0 == j0) rv = lv;
      else if (j0 + cc < p) rv = load_f(x, base + j0 + cc);
      if (WEIGHTED) lv *= w[r];
    }
    nl[m] = lv;
    nr[m] = rv;
  }
}

template <typename T, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS, 4)  // ≤ 64 registers: 4 blocks an SM
gram_partials(const T* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ ws, int64_t n, int p, int64_t rows_per_split) {
  __shared__ __align__(16) float lt[CH][TILE];
  __shared__ __align__(16) float rt[CH][TILE];
  __shared__ float red[4][TILE * TILE];

  const int ti = blockIdx.x, tj = blockIdx.y;
  const int64_t split = blockIdx.z;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);

  const int tid = threadIdx.x;
  const int lane_group = tid >> 6;        // 4 groups of 64 threads
  const int l = tid & 63;
  const int tx = l & 7, ty = l >> 3;      // 8×8 threads, 4×4 outputs each

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  // Each thread stages PER elements of a chunk.  The next chunk's elements
  // are loaded into registers while the current chunk is computed, so the
  // global-memory latency overlaps the FMAs.
  constexpr int PER = CH * TILE / THREADS;
  float nl[PER], nr[PER];
  fetch_chunk<T, WEIGHTED, PER>(x, w, r_begin, r_end, p, i0, j0, tid, nl, nr);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += CH) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + m * THREADS;
      lt[e / TILE][e % TILE] = nl[m];
      rt[e / TILE][e % TILE] = nr[m];
    }
    __syncthreads();
    if (r0 + CH < r_end)
      fetch_chunk<T, WEIGHTED, PER>(x, w, r0 + CH, r_end, p, i0, j0, tid, nl, nr);
#pragma unroll 4
    for (int rr = lane_group; rr < CH; rr += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&lt[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&rt[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[lane_group][(ty * 4 + u) * TILE + tx * 4 + v] = acc[u][v];
  __syncthreads();
  float* out = ws + ((split * gridDim.x + ti) * gridDim.y + tj) * (TILE * TILE);
  for (int e = tid; e < TILE * TILE; e += THREADS)
    out[e] = ((red[0][e] + red[1][e]) + red[2][e]) + red[3][e];
}

// out[i][j] = Σ_s ws[s][ti][tj][i%32][j%32], summed in split order.
__global__ void tile_reduce(const float* __restrict__ ws, float* __restrict__ out,
                            int p, int tiles, int64_t splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)p * p) return;
  const int i = (int)(e / p), j = (int)(e % p);
  const int64_t off = ((int64_t)(i / TILE) * tiles + j / TILE) * (TILE * TILE)
                      + (i % TILE) * TILE + (j % TILE);
  const int64_t stride = (int64_t)tiles * tiles * TILE * TILE;
  float s = 0.f;
  for (int64_t k = 0; k < splits; ++k) s += ws[k * stride + off];
  out[e] = s;
}

template <typename T, bool WEIGHTED>
int launch(const void* x, const void* w, void* ws, void* out, int64_t n, int p,
           int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (p + TILE - 1) / TILE;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid(tiles, tiles, (unsigned)splits);
  gram_partials<T, WEIGHTED><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(ws), n, p, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)p * p;
  tile_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), p, tiles, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ws holds splits·tiles²·1024 floats.
int fm_gram(const void* x, void* ws, void* out, int64_t n, int p, int64_t splits,
            int dtype, void* stream) {
  return dtype == 0 ? launch<float, false>(x, nullptr, ws, out, n, p, splits, stream)
                    : launch<__nv_bfloat16, false>(x, nullptr, ws, out, n, p, splits, stream);
}

// w is float32 (n,).
int fm_wgram(const void* x, const void* w, void* ws, void* out, int64_t n, int p,
             int64_t splits, int dtype, void* stream) {
  return dtype == 0 ? launch<float, true>(x, w, ws, out, n, p, splits, stream)
                    : launch<__nv_bfloat16, true>(x, w, ws, out, n, p, splits, stream);
}

}  // extern "C"
