// G = XᵀX (gram), G = XᵀWX (wgram) for a tall row-major X (n, p), and
// G = XᵀY (xty) for a second row-aligned operand Y (n, q).
//
// Replaces the Pallas kernels repro/kernels/gram.py:_gram_kernel and
// _xty_kernel, and repro/kernels/weighted_gram.py:_wgram_kernel.  The TPU
// grid walked the row blocks in order and kept one (p, q) accumulator in VMEM;
// here the n rows are split over many blocks that run in parallel:
//
//   launch 1 (gram_partials): grid (tiles_p, tiles_q, splits).  Block
//     (ti, tj, s) computes the 32×32 output tile (ti, tj) over its row range:
//     rows are staged through shared memory in chunks of CH rows (the left
//     tile from X's columns, multiplied by w on the way in for wgram; the
//     right tile from X's columns, or Y's for xty; bf16 widened to f32 on
//     load; the next chunk already loading into registers while this one is
//     computed), and each of the 256 threads keeps a 4×4 register tile of
//     the sum.
//     The four row lanes of a block are reduced in shared memory in a fixed
//     order and the block's partial tile goes to the workspace.
//   launch 2 (fm_tile_reduce): one thread per output element sums the splits'
//     partials in split order.  Results are deterministic: no atomics.
//
// Ragged n, p and q are masked while staging (zero rows and columns are
// neutral for a sum of products), so X and Y are never padded or copied.
//
// xty's thin path: when one operand is at most THIN columns wide (the main
// path's shapes: NMF's WᵀX with W (n, 8), GMM's Xᵀr with r (n, 1)), a 32×32
// tile would waste most of its FMAs and staging on masked columns.  Instead
// each warp walks rows of its split: lane l holds wide column 32·tile + l
// (one coalesced load of the row), the narrow operand's few values are
// staged 32 rows at a time in shared memory and read by all lanes at once,
// and each lane keeps the narrow width of sums in registers; the block's 8
// warps are added in order in shared memory and the splits by
// xty_thin_reduce, in order.  Offsets are 64-bit:
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

enum Mode { GRAM = 0, WGRAM = 1, XTY = 2 };

constexpr int THIN = 16;    // widest narrow operand of xty's thin path
constexpr int UNROLL = 8;   // rows in flight per warp on the thin path

// Load one chunk's share of this thread: rows r0.. of the left (X's columns
// from i0) and right (columns from j0 of X, or of Y for xty) tiles, zero past
// the row range or the last column; the left value carries the row weight
// for wgram.
template <typename T, int MODE, int PER>
__device__ __forceinline__ void fetch_chunk(const T* __restrict__ x,
                                            const T* __restrict__ y,
                                            const float* __restrict__ w,
                                            int64_t r0, int64_t r_end, int p,
                                            int q, int i0, int j0, int tid,
                                            float (&nl)[PER], float (&nr)[PER]) {
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS;
    const int rr = e / TILE, cc = e % TILE;
    const int64_t r = r0 + rr;
    float lv = 0.f, rv = 0.f;
    if (r < r_end) {
      if (i0 + cc < p) lv = load_f(x, r * (int64_t)p + i0 + cc);
      if (MODE == XTY) {
        if (j0 + cc < q) rv = load_f(y, r * (int64_t)q + j0 + cc);
      } else if (i0 == j0) {
        rv = lv;
      } else if (j0 + cc < p) {
        rv = load_f(x, r * (int64_t)p + j0 + cc);
      }
      if (MODE == WGRAM) lv *= w[r];
    }
    nl[m] = lv;
    nr[m] = rv;
  }
}

// q is p for gram and wgram (y unused there).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 4)  // ≤ 64 registers: 4 blocks an SM
gram_partials(const T* __restrict__ x, const T* __restrict__ y,
              const float* __restrict__ w, float* __restrict__ ws, int64_t n,
              int p, int q, int64_t rows_per_split) {
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
  fetch_chunk<T, MODE, PER>(x, y, w, r_begin, r_end, p, q, i0, j0, tid, nl, nr);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += CH) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + m * THREADS;
      lt[e / TILE][e % TILE] = nl[m];
      rt[e / TILE][e % TILE] = nr[m];
    }
    __syncthreads();
    if (r0 + CH < r_end)
      fetch_chunk<T, MODE, PER>(x, y, w, r0 + CH, r_end, p, q, i0, j0, tid,
                                nl, nr);
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

// out[i][j] = Σ_s ws[s][ti][tj][i%32][j%32] for the (p, q) output, summed in
// split order.
__global__ void tile_reduce(const float* __restrict__ ws, float* __restrict__ out,
                            int p, int q, int64_t splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)p * q) return;
  const int i = (int)(e / q), j = (int)(e % q);
  const int tiles_p = (p + TILE - 1) / TILE, tiles_q = (q + TILE - 1) / TILE;
  const int64_t off = ((int64_t)(i / TILE) * tiles_q + j / TILE) * (TILE * TILE)
                      + (i % TILE) * TILE + (j % TILE);
  const int64_t stride = (int64_t)tiles_p * tiles_q * TILE * TILE;
  float s = 0.f;
  for (int64_t k = 0; k < splits; ++k) s += ws[k * stride + off];
  out[e] = s;
}

// XᵀY with the narrow operand (X when NARROW_X, else Y) at most THIN wide.
// A warp takes 32 consecutive rows at a time: their narrow values (one
// coalesced read of 32·na values) go to the warp's slice of shared memory,
// then each row's wide value is loaded per lane (UNROLL rows in flight) and
// multiplied by the row's narrow values, read by all lanes at once.
template <typename T, bool NARROW_X>
__global__ void __launch_bounds__(THREADS)
xty_thin_partials(const T* __restrict__ x, const T* __restrict__ y,
                  float* __restrict__ ws, int64_t n, int p, int q,
                  int64_t rows_per_split) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float nar_s[WARPS][32 * THIN];
  __shared__ float red[WARPS][THIN][32];
  const T* nar = NARROW_X ? x : y;
  const T* wid = NARROW_X ? y : x;
  const int na = NARROW_X ? p : q, nw = NARROW_X ? q : p;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  const bool cv = c < nw;
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  float* sh = nar_s[warp];

  float acc[THIN];
#pragma unroll
  for (int i = 0; i < THIN; ++i) acc[i] = 0.f;

  for (int64_t g0 = r_begin + 32 * warp; g0 < r_end; g0 += 32 * WARPS) {
    const int rows = (int)min64(32, r_end - g0);
    for (int e = lane; e < rows * na; e += 32)
      sh[e] = load_f(nar, g0 * na + e);
    __syncwarp();
    int t = 0;
    for (; t + UNROLL <= rows; t += UNROLL) {
      float wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        wv[u] = cv ? load_f(wid, (g0 + t + u) * nw + c) : 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < THIN; ++i)
          if (i < na) acc[i] = fmaf(sh[(t + u) * na + i], wv[u], acc[i]);
    }
    for (; t < rows; ++t) {
      const float w1 = cv ? load_f(wid, (g0 + t) * nw + c) : 0.f;
#pragma unroll
      for (int i = 0; i < THIN; ++i)
        if (i < na) acc[i] = fmaf(sh[t * na + i], w1, acc[i]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < THIN; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)(THIN * 32);
  for (int e = threadIdx.x; e < THIN * 32; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w][e / 32][e % 32];
    out[e] = s;
  }
}

// out (p, q) = Σ_s thin partials, in split order.
__global__ void xty_thin_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, int p, int q,
                                int64_t splits, bool narrow_x) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)p * q) return;
  const int i = (int)(e / q), j = (int)(e % q);
  const int ni = narrow_x ? i : j, wi = narrow_x ? j : i;
  const int nw = narrow_x ? q : p;
  const int64_t stride = (int64_t)((nw + 31) / 32) * THIN * 32;
  const int64_t off = ((int64_t)(wi / 32) * THIN + ni) * 32 + (wi % 32);
  float s = 0.f;
  for (int64_t k = 0; k < splits; ++k) s += ws[k * stride + off];
  out[e] = s;
}

template <typename T>
int launch_thin(const void* x, const void* y, void* ws, void* out, int64_t n,
                int p, int q, int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow_x = p <= q;
  const int nw = narrow_x ? q : p;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((nw + 31) / 32, (unsigned)splits);
  if (narrow_x)
    xty_thin_partials<T, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<float*>(ws), n, p, q, rps);
  else
    xty_thin_partials<T, false><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<float*>(ws), n, p, q, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)p * q;
  xty_thin_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), p, q, splits,
      narrow_x);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch(const void* x, const void* y, const void* w, void* ws, void* out,
           int64_t n, int p, int q, int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_p = (p + TILE - 1) / TILE, tiles_q = (q + TILE - 1) / TILE;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid(tiles_p, tiles_q, (unsigned)splits);
  gram_partials<T, MODE><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(w), static_cast<float*>(ws), n, p, q, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)p * q;
  tile_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), p, q, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ws holds splits·tiles²·1024 floats.
int fm_gram(const void* x, void* ws, void* out, int64_t n, int p, int64_t splits,
            int dtype, void* stream) {
  return dtype == 0
      ? launch<float, GRAM>(x, x, nullptr, ws, out, n, p, p, splits, stream)
      : launch<__nv_bfloat16, GRAM>(x, x, nullptr, ws, out, n, p, p, splits, stream);
}

// w is float32 (n,).
int fm_wgram(const void* x, const void* w, void* ws, void* out, int64_t n, int p,
             int64_t splits, int dtype, void* stream) {
  return dtype == 0
      ? launch<float, WGRAM>(x, x, w, ws, out, n, p, p, splits, stream)
      : launch<__nv_bfloat16, WGRAM>(x, x, w, ws, out, n, p, p, splits, stream);
}

// X (n, p) and Y (n, q) of one dtype; out is (p, q).  ws holds
// splits·tiles_p·tiles_q·1024 floats, or on the thin path (min(p, q) ≤ THIN)
// splits·ceil(max(p, q)/32)·THIN·32.
int fm_xty(const void* x, const void* y, void* ws, void* out, int64_t n, int p,
           int q, int64_t splits, int dtype, void* stream) {
  if ((p < q ? p : q) <= THIN)
    return dtype == 0
        ? launch_thin<float>(x, y, ws, out, n, p, q, splits, stream)
        : launch_thin<__nv_bfloat16>(x, y, ws, out, n, p, q, splits, stream);
  return dtype == 0
      ? launch<float, XTY>(x, y, nullptr, ws, out, n, p, q, splits, stream)
      : launch<__nv_bfloat16, XTY>(x, y, nullptr, ws, out, n, p, q, splits, stream);
}

}  // extern "C"
