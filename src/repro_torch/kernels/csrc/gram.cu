// G = XᵀX (gram), G = XᵀWX (wgram) for a tall row-major X (n, p), and
// G = XᵀY (xty) for a second row-aligned operand Y (n, q).  wgram at p ≤ 32
// takes its own body (wgram_tri_partials, whose note is below); the tile
// body described here serves gram, xty's wide operands and wgram at p > 32.
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
// tile would waste most of its FMAs and staging on masked columns.  Its
// bound is bytes: both operands read once (2.6 ms at GMM's shape, 3.1 ms at
// NMF's, at 3.35 TB/s).  The design streams them at that rate:
//   * the narrow width is a template parameter NA ∈ {1, 2, 4, 8, 16} (na
//     rounded up, the missing columns read as zeros), so a row costs
//     exactly NA·4 FMAs a thread and no guarded loop runs per element;
//   * eight threads read a row's 32 wide values as 16-byte loads, a warp
//     four rows a load; the narrow values of a row come as one or a few
//     vector loads that the row's eight threads share (one transaction);
//   * bytes in flight come from register batches: each thread issues the
//     loads of its next U rows (8, 4 or 2 as NA grows) together before it
//     multiplies them, and launch bounds keep 2-4 blocks an SM resident:
//     96-128 KB of loads in flight an SM at the main path's widths.  A
//     cp.async / TMA ring was the other route; it needs each block's rows
//     to be one contiguous slab, which holds only for a wide operand of
//     exactly 32 columns, while register batches serve every width with
//     the same code.  The same staging may later serve gram / wgram
//     (ROADMAP §B);
//   * lanes, warps and then splits (xty_thin_reduce) are added in a fixed
//     order: deterministic, no atomics.
// Offsets are 64-bit: n·p reaches 2^31 at the sizes this runs at.  Plain
// f32 FMA, no tensor cores: the reference tests hold f32 at 1e-4.
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

// Σ_r nar[r][i]·wid[r][j] over one split's rows for the narrow operand
// (na ≤ NA columns, NA ∈ {1, 2, 4, 8, 16} a compile-time width; columns past
// na read as zeros and are never stored) and one 32-column tile of the wide
// operand (nw columns).  Thread t owns wide columns 4·(t % 8) .. +3 of the
// tile and rows t / 8, +32, +64, ... of the split: eight threads read one
// row's 32 wide values as 16-byte loads, a warp reads four rows, the block
// 32.  The narrow values of a row are read as vectors (the eight threads of
// a row read the same bytes: one transaction, broadcast).  Each thread
// issues the loads of its next U rows together and then multiplies them;
// with MINB blocks an SM that keeps 256·MINB·U·16 bytes of the wide
// operand in flight (128 KB an SM at NA = 1).  MINB is the launch bound
// alone (the registers a thread may take); the split count, and so the
// blocks a launch gives an SM, is gram.py's THIN_BLOCKS.  U and MINB were
// tuned at NA = 1 and 8 on the H100 (PERF.md); NA = 2, 4 and 16
// were not timed, their U and MINB set so that ptxas fits the FAST body
// without spills.  FAST: na == NA, nw a multiple of 4 and both bases
// aligned, so every load is a vector (columns past nw read as zeros, never
// loaded); else every value is a guarded scalar load.  The 32 row lanes
// are added by shuffles, then the warps, in a fixed order; the block's
// NA × 32 partial goes to ws[split][tile] (THIN × 32 floats a tile).
template <int NA>
struct ThinCfg {
  static constexpr int U = NA <= 2 ? 8 : NA <= 8 ? 4 : 2;   // rows a batch
  static constexpr int MINB = NA == 1 ? 4 : NA <= 4 ? 3 : 2;  // blocks an SM
};

template <bool FAST, int NA>
__device__ __forceinline__ void load_narrow(const float* __restrict__ p, int na,
                                            float (&v)[NA]) {
  if constexpr (FAST && NA % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i / 4);
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else if constexpr (FAST && NA == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  } else if constexpr (FAST) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < NA; ++i) v[i] = i < na ? __ldg(p + i) : 0.f;
  }
}

template <bool FAST, int NA>
__device__ __forceinline__ void load_narrow(const __nv_bfloat16* __restrict__ p,
                                            int na, float (&v)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) v[i] = i < na ? __bfloat162float(p[i]) : 0.f;
}

// The 4 wide values at columns c .. c+3 of one row (zeros past nw).  FAST
// has nw a multiple of 4, so c < nw covers all four.
template <bool FAST>
__device__ __forceinline__ void load_wide(const float* __restrict__ p, int c,
                                          int nw, float (&v)[4]) {
  if constexpr (FAST) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nw) f = __ldg(reinterpret_cast<const float4*>(p + c));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < nw ? __ldg(p + c + e) : 0.f;
  }
}

template <bool FAST>
__device__ __forceinline__ void load_wide(const __nv_bfloat16* __restrict__ p,
                                          int c, int nw, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < nw ? __bfloat162float(p[c + e]) : 0.f;
}

template <typename T, int NA, bool FAST>
__global__ void __launch_bounds__(THREADS, ThinCfg<NA>::MINB)
xty_thin_partials(const T* __restrict__ nar, const T* __restrict__ wid,
                  float* __restrict__ ws, int64_t n, int na, int nw,
                  int64_t rows_per_split) {
  constexpr int U = ThinCfg<NA>::U;
  constexpr int WARPS = THREADS / 32;
  constexpr int RSTEP = THREADS / 8;  // rows a block reads per step
  __shared__ float red[WARPS][NA][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid & 7;
  const int c = blockIdx.x * 32 + sub * 4;
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  // FAST: na == NA (compile-time row strides help the address arithmetic).
  const int nstride = FAST ? NA : na;

  float acc[NA][4];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int64_t r = r_begin + (tid >> 3); r < r_end; r += (int64_t)U * RSTEP) {
    float nv[U][NA], wv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // rows at or past r_end read as zeros
      const int64_t row = r + (int64_t)u * RSTEP;
      if (row < r_end) {
        load_narrow<FAST, NA>(nar + row * nstride, na, nv[u]);
        load_wide<FAST>(wid + row * nw, c, nw, wv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < NA; ++i) nv[u][i] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(nv[u][i], wv[u][e], acc[i][e]);
  }

  // Lanes l, l+8, l+16, l+24 share columns: add them (fixed order), then
  // the warps in order.
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[i][e];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][e] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][i][sub * 4 + e] = acc[i][e];
  }
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)(THIN * 32);
  for (int e = tid; e < na * 32; e += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][e / 32][e % 32];
    out[e] = s;
  }
}

// out (p, q) = Σ_s thin partials: a warp an output element, lane l adding
// splits l, l + 32, ... in order, then the lanes by a fixed shuffle tree
// (deterministic; a thousand splits are 33 loads a lane, not a thousand
// dependent ones).
__global__ void xty_thin_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, int p, int q,
                                int64_t splits, bool narrow_x) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (e >= (int64_t)p * q) return;  // whole warps leave together
  const int i = (int)(e / q), j = (int)(e % q);
  const int ni = narrow_x ? i : j, wi = narrow_x ? j : i;
  const int nw = narrow_x ? q : p;
  const int64_t stride = (int64_t)((nw + 31) / 32) * THIN * 32;
  const int64_t off = ((int64_t)(wi / 32) * THIN + ni) * 32 + (wi % 32);
  float s = 0.f;
  for (int64_t k = lane; k < splits; k += 32) s += ws[k * stride + off];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) out[e] = s;
}

template <typename T, int NA>
void launch_thin_na(const T* nar, const T* wid, float* ws, int64_t n, int na,
                    int nw, int64_t splits, bool fast, cudaStream_t st) {
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((nw + 31) / 32, (unsigned)splits);
  if (fast)
    xty_thin_partials<T, NA, true><<<grid, THREADS, 0, st>>>(nar, wid, ws, n, na, nw, rps);
  else
    xty_thin_partials<T, NA, false><<<grid, THREADS, 0, st>>>(nar, wid, ws, n, na, nw, rps);
}

template <typename T>
int launch_thin(const void* x, const void* y, void* ws, void* out, int64_t n,
                int p, int q, int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow_x = p <= q;
  const T* nar = static_cast<const T*>(narrow_x ? x : y);
  const T* wid = static_cast<const T*>(narrow_x ? y : x);
  const int na = narrow_x ? p : q, nw = narrow_x ? q : p;
  const int NA = na <= 1 ? 1 : na <= 2 ? 2 : na <= 4 ? 4 : na <= 8 ? 8 : 16;
  // Vector loads need every row start aligned: float32, na a built width,
  // nw a multiple of 4 and aligned bases.
  const bool fast = sizeof(T) == 4 && na == NA && nw % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(wid) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(nar) % (NA >= 4 ? 16 : 4 * NA) == 0;
  float* w = static_cast<float*>(ws);
  switch (NA) {
    case 1: launch_thin_na<T, 1>(nar, wid, w, n, na, nw, splits, fast, st); break;
    case 2: launch_thin_na<T, 2>(nar, wid, w, n, na, nw, splits, fast, st); break;
    case 4: launch_thin_na<T, 4>(nar, wid, w, n, na, nw, splits, fast, st); break;
    case 8: launch_thin_na<T, 8>(nar, wid, w, n, na, nw, splits, fast, st); break;
    default: launch_thin_na<T, 16>(nar, wid, w, n, na, nw, splits, fast, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t warps = (int64_t)p * q;  // one an output element
  xty_thin_reduce<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
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

// ---------------------------------------------------------------------------
// wgram for p ≤ 32 (wgram_tri_partials).  The tile body above computes all
// p² products of a row in one 32×32 tile (1,024 FMAs a row at p = 32, though
// XᵀWX is symmetric), feeds each 16 FMAs with two 16-byte shared loads
// (2 KB of shared reads a row), multiplies the weight into every staged
// element (32 loads of w a row), and stages with scalar loads and two
// __syncthreads a 64-row chunk.  At Friendster-32 it ran at 4× the bytes
// bound (10.4 ms against 2.59).  This body:
//   * Only the upper triangle, in 8×8 register tiles: the columns fall in
//     nb = ceil(p / 8) blocks of 8 and the nb(nb+1)/2 block pairs (I ≤ J)
//     are the tiles of a row (10 at p = 32: 640 FMAs a row, not 1,024).
//     A lane owns one tile of one row slot: a warp takes 32 / tiles rows a
//     step (3 at p = 32; lanes 30 and 31 repeat a tile and are dropped).
//     The diagonal tiles compute all 64 products and keep those with a ≤ b.
//   * The row side is multiplied by w[r] in registers, once per operand
//     value (8 FMULs a lane a row); w is read once a row (a broadcast).
//   * Rows arrive by bulk asynchronous copies: X is row-major and a block
//     takes all p columns, so a split's rows are one contiguous slab, and
//     each chunk of R rows (with its R weights) is one cp.async.bulk of
//     R·p elements into a ring of `stages` stages in shared memory,
//     completing on the stage's mbarrier.  Thread 0 refills a stage once
//     every thread has passed the __syncthreads after reading it, so
//     stages − 1 chunks are in flight while one is computed (64 KB a
//     block at 3 stages of up to 32 KB, two blocks an SM) and no register
//     holds a load.  R is a multiple of 8 and of the rows a block takes a
//     step (24 at p = 32: a __syncthreads every 10 steps), so a chunk of
//     f32 or bf16 rows at any p is a multiple of 16 bytes; rows_per_split is a multiple of R, so
//     every full chunk starts 16-byte aligned when X and w do (the wrapper
//     copies a base that does not).  The split's last, partial chunk is
//     read with plain loads.
//   * FAST (p a multiple of 8, so every 8-column block lies inside p): a
//     block is two 16-byte shared loads of f32 (one of bf16, widened in
//     registers); else guarded scalar loads, zero past p.
//   * The row slots of a warp are added by shuffles in slot order, the
//     warps in warp order, the splits (wgram_tri_reduce) in split order,
//     and the lower triangle is the mirror: deterministic, no atomics.
// Geometry (R, stages, splits, shared bytes) is gram.py's wgram_plan, a
// function of (n, p, dtype) alone.
constexpr int TRI_THREADS = 256;
constexpr int TRI_WARPS = TRI_THREADS / 32;
constexpr int TRI_BARS = 64;  // bytes before the ring: one mbarrier a stage (≤ 8)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The tile (I, J), I ≤ J, of index t in row-major order of the upper
// triangle of an nb × nb grid of 8-column blocks.
__device__ __forceinline__ void tri_tile(int t, int nb, int& I, int& J) {
  I = 0;
  while (t >= nb - I) {
    t -= nb - I;
    ++I;
  }
  J = I + t;
}

// v = row[c0 .. c0 + 7] widened to f32, zeros at or past p.  FAST: p % 8
// == 0 and the row 16-byte aligned, so c0 + 8 <= p.
template <bool FAST>
__device__ __forceinline__ void load8(const float* row, int p, int c0,
                                      float (&v)[8]) {
  if (FAST) {
    const float4 a = *reinterpret_cast<const float4*>(row + c0);
    const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = c0 + k < p ? row[c0 + k] : 0.f;
  }
}

template <bool FAST>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int p, int c0,
                                      float (&v)[8]) {
  if (FAST) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c0);
    const unsigned h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k is the low half
      v[2 * k] = __uint_as_float(h[k] << 16);
      v[2 * k + 1] = __uint_as_float(h[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = c0 + k < p ? __bfloat162float(row[c0 + k]) : 0.f;
  }
}

// acc += (w_r · x_r[I block])ᵀ x_r[J block] over the staged rows first,
// first + stride, … < rows.
template <typename T, bool FAST>
__device__ __forceinline__ void tri_rows(const T* sx, const float* sw, int rows,
                                         int p, int I, int J, int first,
                                         int stride, float (&acc)[8][8]) {
  for (int r = first; r < rows; r += stride) {
    float a[8], b[8];
    load8<FAST>(sx + r * p, p, 8 * I, a);
    load8<FAST>(sx + r * p, p, 8 * J, b);
    const float wr = sw[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] *= wr;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Thread 0: chunk k of the split (R rows from r0) into stage k % stages.
template <typename T>
__device__ __forceinline__ void tri_issue(const T* x, const float* w,
                                          int64_t r0, int p, int R, int stages,
                                          int k, uint32_t ring, int sbytes,
                                          uint32_t bars) {
  const int s = k % stages;
  const uint32_t xbytes = (uint32_t)R * p * sizeof(T);
  const uint32_t dst = ring + (uint32_t)s * sbytes;
  mbar_expect_tx(bars + 8 * s, (uint32_t)sbytes);
  bulk_load(dst, x + r0 * p, xbytes, bars + 8 * s);
  bulk_load(dst + xbytes, w + r0, (uint32_t)R * 4, bars + 8 * s);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(TRI_THREADS, 2)
wgram_tri_partials(const T* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ ws, int64_t n, int p, int R, int stages,
                   int64_t rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = (p + 7) / 8, tiles = nb * (nb + 1) / 2, rps = 32 / tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane % tiles, slot = min(lane / tiles, rps - 1);
  int I, J;
  tri_tile(t, nb, I, J);
  const int xbytes = R * p * (int)sizeof(T), sbytes = xbytes + R * 4;
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = bars + TRI_BARS;
  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const int64_t rows = r_end > r_begin ? r_end - r_begin : 0;
  const int nfull = (int)(rows / R), tail = (int)(rows - (int64_t)nfull * R);
  const int first = warp * rps + slot, stride = TRI_WARPS * rps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(stages, nfull); ++k)
      tri_issue(x, w, r_begin + (int64_t)k * R, p, R, stages, k, ring, sbytes,
                bars);
  }
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < nfull; ++k) {
    const int s = k % stages;
    mbar_wait(bars + 8 * s, (uint32_t)(k / stages) & 1u);
    const unsigned char* st = smem + TRI_BARS + s * sbytes;
    tri_rows<T, FAST>(reinterpret_cast<const T*>(st),
                      reinterpret_cast<const float*>(st + xbytes), R, p, I, J,
                      first, stride, acc);
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + stages < nfull)
      tri_issue(x, w, r_begin + (int64_t)(k + stages) * R, p, R, stages,
                k + stages, ring, sbytes, bars);
  }
  if (tail) {  // plain loads into stage 0: every copy has landed and been read
    T* sx = reinterpret_cast<T*>(smem + TRI_BARS);
    float* sw = reinterpret_cast<float*>(smem + TRI_BARS + xbytes);
    const int64_t r0 = r_begin + (int64_t)nfull * R;
    for (int e = threadIdx.x; e < tail * p; e += TRI_THREADS) sx[e] = x[r0 * p + e];
    for (int e = threadIdx.x; e < tail; e += TRI_THREADS) sw[e] = w[r0 + e];
    __syncthreads();
    tri_rows<T, FAST>(sx, sw, tail, p, I, J, first, stride, acc);
  }

  // Row slots in slot order (lane t collects lanes t + tiles·s), then the
  // warps in warp order through the ring, now free.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j];
      for (int s = 1; s < rps; ++s)
        v += __shfl_sync(0xffffffffu, acc[i][j], min(lane + s * tiles, 31));
      acc[i][j] = v;
    }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + TRI_BARS);
  if (lane < tiles) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(warp * tiles + lane) * 64 + i * 8 + j] = acc[i][j];
  }
  __syncthreads();
  float* out = ws + (int64_t)blockIdx.x * p * p;
  for (int e = threadIdx.x; e < tiles * 64; e += TRI_THREADS) {
    int I2, J2;
    tri_tile(e >> 6, nb, I2, J2);
    const int i = 8 * I2 + ((e >> 3) & 7), j = 8 * J2 + (e & 7);
    if (i < p && j < p && i <= j) {
      float sum = 0.f;
      for (int v = 0; v < TRI_WARPS; ++v) sum += red[(v * tiles + (e >> 6)) * 64 + (e & 63)];
      out[i * p + j] = sum;
    }
  }
}

// out (p, p) = Σ_s upper-triangle partials, mirrored: a warp an output
// element, lane l adding splits l, l + 32, … in order, then the lanes by a
// fixed shuffle tree.
__global__ void wgram_tri_reduce(const float* __restrict__ ws,
                                 float* __restrict__ out, int p,
                                 int64_t splits) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (e >= (int64_t)p * p) return;  // whole warps leave together
  const int a = (int)(e / p), b = (int)(e % p);
  const int64_t off = (int64_t)min(a, b) * p + max(a, b);
  float s = 0.f;
  for (int64_t k = lane; k < splits; k += 32) s += ws[k * p * p + off];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) out[e] = s;
}

// Shared bytes of a wgram_tri block: the barriers, then the larger of the
// ring and the warps' tile partials (gram.py wgram_plan says the same).
int64_t tri_smem(int p, int R, int stages, int elem) {
  const int nb = (p + 7) / 8, tiles = nb * (nb + 1) / 2;
  const int64_t ring = (int64_t)stages * R * (p * elem + 4);
  const int64_t red = (int64_t)TRI_WARPS * tiles * 64 * 4;
  return TRI_BARS + (ring > red ? ring : red);
}

template <typename T>
int launch_tri(const void* x, const void* w, void* ws, void* out, int64_t n,
               int p, int R, int stages, int64_t rows_per_split, int64_t splits,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p < 1 || p > 32 || R % 8 != 0 || stages < 1 || stages > TRI_BARS / 8 ||
      rows_per_split % R != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = tri_smem(p, R, stages, (int)sizeof(T));
  const bool fast = p % 8 == 0;
  auto kern = fast ? wgram_tri_partials<T, true> : wgram_tri_partials<T, false>;
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)splits, TRI_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(ws), n, p, R, stages, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t warps = (int64_t)p * p;  // one an output element
  wgram_tri_reduce<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), p, splits);
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

// w is float32 (n,).  The tile body: any p (p > 32 takes it).
int fm_wgram(const void* x, const void* w, void* ws, void* out, int64_t n, int p,
             int64_t splits, int dtype, void* stream) {
  return dtype == 0
      ? launch<float, WGRAM>(x, x, w, ws, out, n, p, p, splits, stream)
      : launch<__nv_bfloat16, WGRAM>(x, x, w, ws, out, n, p, p, splits, stream);
}

// The triangle body for p ≤ 32: x and w (float32 (n,)) 16-byte aligned,
// rows_per_split a multiple of R (a multiple of 8); ws holds splits·p²
// floats.  Geometry from gram.py wgram_plan.
int fm_wgram_tri(const void* x, const void* w, void* ws, void* out, int64_t n,
                 int p, int R, int stages, int64_t rows_per_split,
                 int64_t splits, int dtype, void* stream) {
  return dtype == 0
      ? launch_tri<float>(x, w, ws, out, n, p, R, stages, rows_per_split,
                          splits, stream)
      : launch_tri<__nv_bfloat16>(x, w, ws, out, n, p, R, stages,
                                  rows_per_split, splits, stream);
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
