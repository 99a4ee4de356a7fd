// Sparse (ELL) contractions for the one-hot tier: XᵀX (spmm_gram), XᵀWX
// (spmm_wgram) and XᵀY (spmm_xty), X an ELL slab of n rows, ncol logical
// columns and kmax stored entries a row (cols int32, vals float32, both
// (n, kmax) row-major), padded with (col 0, val 0).
//
// Replaces the Pallas kernels repro/kernels/spmm.py:_spmm_gram_kernel,
// _spmm_xty_kernel and _spmm_wgram_kernel.  The TPU kernels scatter each row
// block into a dense (rows, ncol) VMEM tile and contract it on the MXU with a
// (ncol, ncol) accumulator in VMEM.  On Hopper that accumulator does not fit
// on chip (ncol = 1,664 is 11.1 MB), and a dense tile would do ncol/kmax
// times the work, so each kernel adds the products of a row's stored entries
// straight into an output tile held in shared memory:
//
//   launch 1 (*_partials): grid (tiles, splits), tiles fastest.  The output
//     is cut into tiles that fit in shared memory; block (t, s) owns tile t
//     over the row range of split s and adds every product that falls into
//     it with shared-memory atomics.  The blocks of one split are launched
//     next to each other, so they read the same rows from L2 at about the
//     same time: the slab comes from device memory about once.
//       XᵀX / XᵀWX: square tiles (I, J) of ts×ts with I ≤ J (the rest is
//     the mirror image), 1,024 threads and the whole of the block's shared
//     memory for the tile (ts = 240, 28 tiles at ncol = 1,664).  A warp takes
//     a row, its lanes the row's entries, read straight from global memory
//     (no staging), the next rows' loads in flight; two ballots mark the
//     entries in the tile's row and column ranges, and each in-tile entry
//     of the I side takes one warp step, the J side's lanes adding its
//     products.  Rows wider than 32 entries go in 32-entry chunks, each I
//     chunk against each J chunk, so any kmax is taken.
//       XᵀY: stripes of cs rows × qc of Y's columns (one stripe of all
//     ncol rows at Criteo).  A warp takes a row, its lanes the row's entries
//     straight from global memory, and adds v·y_j into a copy of the stripe
//     that is its own: no atomics (see spmm_xty_partials).
//   launch 2 (*_reduce): the splits' partial tiles summed in split order
//     (and the I < J tiles mirrored for XᵀX).
//
// Shared-memory float atomics compile to compare-and-swap loops
// (ATOMS.CAST.SPIN) on sm_90a; at the Criteo shape spmm_gram makes about 390
// of them a row over its 28 tiles, and each tile reads every row once from
// L2 — these, not the slab's bytes, set its time.  XᵀY makes none.
//
// Accuracy: f32 throughout, as the reference.  A frequent level's entry sums
// millions of terms; each split's partial sums only its own rows (the wrapper
// caps rows per split and the workspace), and the splits are combined in a
// fixed order, so no single f32 accumulator takes all n rows.  Shared-memory
// atomics make the order inside a split of XᵀX vary from run to run; XᵀY
// adds in a fixed order and is the same bit for bit on every call.
//
// Zero entries (the padding) are skipped: for finite values they add
// nothing, and (col 0, val 0) padding would otherwise pile adds onto
// column 0.  Column indices outside [0, ncol) fall in no tile and are
// dropped.  Offsets are 64-bit: n·kmax reaches 1.2e9 at Criteo scale.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The square tile (I, J), I ≤ J, of linear index t in row-major order of the
// upper triangle of an nst × nst grid of tiles.
__device__ __forceinline__ void tile_of(int t, int nst, int& I, int& J) {
  I = 0;
  while (t >= nst - I) {
    t -= nst - I;
    ++I;
  }
  J = I + t;
}

constexpr int GRAM_THREADS = 1024;           // 32 warps, one block an SM
constexpr int GRAM_WARPS = GRAM_THREADS / 32;
constexpr int AHEAD = 3;                      // rows a warp has in flight
constexpr unsigned FULL = 0xffffffffu;

// *(float*)a += v at the 32-bit shared address a; no value returned.
__device__ __forceinline__ void shared_add(unsigned a, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Entry (c, v) of the row at c_ptr / v_ptr (this lane's entry, lane <
// kmax), the row's weight w; (-1, 0, 1) when there is no such row or entry.
template <bool WEIGHTED>
__device__ __forceinline__ void fetch_row(bool row, bool entry,
                                          const int* c_ptr, const float* v_ptr,
                                          const float* w_ptr, int& c, float& v,
                                          float& w) {
  c = -1;
  v = 0.f;
  w = 1.f;
  if (row) {
    if (entry) {
      c = __ldg(c_ptr);
      v = __ldg(v_ptr);
    }
    if (WEIGHTED) w = __ldg(w_ptr);
  }
}

// Add the products of one 32-entry chunk pair of a row into the tile at
// shared address acc (row stride rb = 4·ts bytes): lane a holds entry
// (ca, va·w_r) of the I side, lane b (cb, vb) of the J side; mI, mJ mark the
// entries in the tile's row / column range.  One warp step per set bit a
// of mI: its entry is broadcast by two shuffles and the lanes of mJ add
// va·vb at (ca − i0, cb − j0).  Distinct columns give distinct addresses;
// duplicates stay right because the add is atomic.
__device__ __forceinline__ void add_pairs(unsigned acc, int rb, int i0, int j0,
                                          unsigned mI, int ca, float va,
                                          unsigned mJ, int cb, float vb) {
  const bool mine = (mJ >> (threadIdx.x & 31)) & 1u;
  const unsigned col = acc + 4u * (unsigned)(cb - j0) - (unsigned)(i0 * rb);
  for (unsigned m = mI; m; m &= m - 1) {
    const int a = __ffs(m) - 1;
    const int c = __shfl_sync(FULL, ca, a);
    const float v = __shfl_sync(FULL, va, a);
    if (mine) shared_add(col + (unsigned)(c * rb), v * vb);
  }
}

// Block (t, s) adds, over the rows of split s, every product x_ra·x_rb (·w_r)
// whose (col_a, col_b) falls in square tile t of the upper triangle into
// that tile in shared memory, then writes the tile to its workspace slot.
// Warp w takes rows r_begin + w, + 32, …; lane k holds the row's entry k,
// so a row is two coalesced loads of 4·kmax bytes and a broadcast of w_r.
// Two ballots mark the row's entries in the tile's row and column ranges;
// a row with none on either side costs nothing more.  The next AHEAD rows
// are loaded before the current one is worked, so each warp keeps that
// many rows' loads in flight.  WIDE (kmax > 32): the prefetched registers
// hold a row's first 32 entries, and its other 32-entry chunks are loaded
// as each I chunk meets each J chunk.
template <bool WEIGHTED, bool WIDE>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
spmm_gram_partials(const int* __restrict__ cols, const float* __restrict__ vals,
                   const float* __restrict__ w, float* __restrict__ ws,
                   int64_t n, int kmax, int ncol, int ts, int nst,
                   int64_t rows_per_split) {
  extern __shared__ __align__(16) float tile[];
  int I, J;
  tile_of(blockIdx.x, nst, I, J);
  const int i0 = I * ts, i1 = min(ncol, i0 + ts);
  const int j0 = J * ts, j1 = min(ncol, j0 + ts);
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const int lane = threadIdx.x & 31;
  const unsigned acc = static_cast<unsigned>(__cvta_generic_to_shared(tile));
  const int rb = 4 * ts;

  for (int e = threadIdx.x; e < ts * ts; e += GRAM_THREADS) tile[e] = 0.f;
  __syncthreads();

  // This warp's rows are r0 + 32·i, i < nr; f* point at row i + AHEAD's
  // entry `lane` (and weight), r* at row i's.
  const int64_t r0 = r_begin + (threadIdx.x >> 5);
  const int nr = r0 < r_end ? (int)((r_end - r0 + GRAM_WARPS - 1) / GRAM_WARPS) : 0;
  const int64_t step = (int64_t)GRAM_WARPS * kmax;
  const bool entry = lane < kmax;
  const int* fc = cols + r0 * kmax + lane;
  const float* fv = vals + r0 * kmax + lane;
  const float* fw = WEIGHTED ? w + r0 : nullptr;
  const int* rc = fc;
  const float* rv = fv;
  int qc[AHEAD];
  float qv[AHEAD], qw[AHEAD];
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    fetch_row<WEIGHTED>(s < nr, entry, fc, fv, fw, qc[s], qv[s], qw[s]);
    fc += step;
    fv += step;
    if (WEIGHTED) fw += GRAM_WARPS;
  }
  for (int i = 0; i < nr; ++i) {
    const int c0 = qc[0];
    const float v0 = qv[0], wr = qw[0];
#pragma unroll
    for (int s = 0; s + 1 < AHEAD; ++s) {
      qc[s] = qc[s + 1];
      qv[s] = qv[s + 1];
      qw[s] = qw[s + 1];
    }
    fetch_row<WEIGHTED>(i + AHEAD < nr, entry, fc, fv, fw, qc[AHEAD - 1],
                        qv[AHEAD - 1], qw[AHEAD - 1]);
    fc += step;
    fv += step;
    if (WEIGHTED) fw += GRAM_WARPS;
    if (!WIDE) {
      const bool live = v0 != 0.f;
      const unsigned mI = __ballot_sync(FULL, live && c0 >= i0 && c0 < i1);
      const unsigned mJ = __ballot_sync(FULL, live && c0 >= j0 && c0 < j1);
      if (mI && mJ) add_pairs(acc, rb, i0, j0, mI, c0, v0 * wr, mJ, c0, v0);
    } else {
      for (int a0 = 0; a0 < kmax; a0 += 32) {
        int ca = c0;
        float va = v0, unused;
        if (a0) fetch_row<false>(true, a0 + lane < kmax, rc + a0, rv + a0,
                                 nullptr, ca, va, unused);
        const unsigned mI = __ballot_sync(FULL, va != 0.f && ca >= i0 && ca < i1);
        if (!mI) continue;
        for (int b0 = 0; b0 < kmax; b0 += 32) {
          int cb = b0 ? ca : c0;
          float vb = b0 ? va : v0;
          if (b0 && b0 != a0)
            fetch_row<false>(true, b0 + lane < kmax, rc + b0, rv + b0, nullptr,
                             cb, vb, unused);
          const unsigned mJ =
              __ballot_sync(FULL, vb != 0.f && cb >= j0 && cb < j1);
          if (mJ) add_pairs(acc, rb, i0, j0, mI, ca, va * wr, mJ, cb, vb);
        }
      }
    }
    rc += step;
    rv += step;
  }
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)ts * ts;
  for (int e = threadIdx.x; e < ts * ts; e += GRAM_THREADS) out[e] = tile[e];
}

// out (ncol, ncol) = Σ_s partial tiles, in split order; entry (i, j) of a
// tile below the diagonal is entry (j, i) of its mirror.
__global__ void spmm_gram_reduce(const float* __restrict__ ws,
                                 float* __restrict__ out, int ncol, int ts,
                                 int nst, int64_t splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)ncol * ncol) return;
  int i = (int)(e / ncol), j = (int)(e % ncol);
  if (i / ts > j / ts) {
    const int t = i;
    i = j;
    j = t;
  }
  const int I = i / ts, J = j / ts;
  const int64_t tile = (int64_t)I * nst - (int64_t)I * (I - 1) / 2 + (J - I);
  const int64_t ntiles = (int64_t)nst * (nst + 1) / 2;
  const int64_t tt = (int64_t)ts * ts;
  const int64_t off = tile * tt + (int64_t)(i - I * ts) * ts + (j - J * ts);
  float s = 0.f;
  for (int64_t k = 0; k < splits; ++k) s += ws[k * ntiles * tt + off];
  out[e] = s;
}

template <typename K>
cudaError_t allow_smem(K kern, int64_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;   // 227 KB a block
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool WEIGHTED, bool WIDE>
int launch_gram(const void* cols, const void* vals, const void* w, void* ws,
                void* out, int64_t n, int kmax, int ncol, int ts,
                int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nst = (ncol + ts - 1) / ts;
  const int ntiles = nst * (nst + 1) / 2;
  const int64_t smem = 4 * (int64_t)ts * ts;
  auto kern = spmm_gram_partials<WEIGHTED, WIDE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((unsigned)ntiles, (unsigned)splits);
  kern<<<grid, GRAM_THREADS, smem, st>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<float*>(ws), n, kmax, ncol, ts,
      nst, rps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)ncol * ncol;
  spmm_gram_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), ncol, ts, nst,
      splits);
  return (int)cudaGetLastError();
}

// XᵀY: block (t, s) adds, over the rows of split s, v·y_j for every stored
// entry (c, v) of a row whose c falls in stripe t's rows [c0, c1), for Y's
// columns [q0, q0 + nq) of the stripe.
//
// Bound: reading the slab and Y once, 2.9 ms at Criteo (q = 1).  A stripe
// shared by the block would take every one of the 1.19e9 entries through a
// shared-memory atomic (a CAS loop on sm_90a, the Zipf codes sending a
// warp's rows to the same few addresses), and staging rows beside it
// would leave a wide row no room.  So:
//   * A warp takes a row (rows r_begin + warp, + warps, …), lane a its
//     entry a0 + a, loaded straight from global memory; XTY_AHEAD rows of
//     loads are in flight a warp (a ring of registers, each slot refilled
//     once its row is added).  Lane j < nq loads Y's value of column q0 + j
//     once a row and the add takes it by a shuffle; for q = 1 (ONE) every
//     lane loads the one value, a single broadcast transaction.  (ptxas
//     turns the ring into a queue shifted by MOVs, and a MOV waits for the
//     load it copies, issued one row earlier: each row waits out a load's
//     latency, which sets this body's 6.9 ms at Criteo — PERF.md §6.)
//   * Each warp adds into a copy of the stripe (cs·qc floats) of its own in
//     shared memory, so the add is a plain load, FMA and store — no atomic —
//     as long as the 32 lanes of a step hold distinct columns.  A one-hot
//     row never repeats a column and fm.one_hot writes its columns in
//     increasing order, so one shuffle and one vote test "the non-zero
//     entries of this 32-entry chunk are lanes 0.. with strictly increasing
//     columns"; only a chunk that fails it (a duplicate, an unsorted row,
//     padding between entries) groups equal columns with __match_any_sync,
//     and the group's lowest lane sums its values in lane order before the
//     add.  __syncwarp orders one step's stores before the next step's
//     loads.
//   * Rows wider than 32 entries go in 32-entry chunks one after another
//     (WIDE), so any kmax is taken: no staging buffer competes with the
//     stripe for shared memory.
//   * Banks: a one-hot column is factor·64 + code, and Zipf codes crowd
//     near 0, so in a plain layout the lanes of a row meet on bank 0.  The
//     copy is indexed by skew(e) = e + (e >> 6): one float of padding every
//     64, which moves factor f's block by f banks, so one level of the 26
//     factors lands on 26 different banks.  (c ^ ((c >> 5) & 31) puts f and
//     f + 16 on one bank.)
//   * The block adds its warps' copies in warp order into the split's
//     partial, spmm_xty_reduce the splits in split order: the same result
//     bit for bit on every call.
// Shapes (spmm.py xty_tile): qc = min(q, 32) and the most warps (≤ 32)
// whose copies of all ncol rows fit 227 KB: 32 warps × 6,756 bytes at
// Criteo, one stripe.  A stripe that would leave fewer than XTY_MIN_WARPS
// warps is cut into rows that fit that many.
constexpr int XTY_AHEAD = 6;  // rows a warp has in flight

__host__ __device__ __forceinline__ int skew(int e) { return e + (e >> 6); }

// Entry (c, v) of this lane (lane < kmax) and Y's value y of the row; (-1,
// 0, 0) when there is no such row or entry.
__device__ __forceinline__ void fetch_xty(bool row, bool entry, bool ylane,
                                          const int* c_ptr, const float* v_ptr,
                                          const float* y_ptr, int& c, float& v,
                                          float& y) {
  c = -1;
  v = 0.f;
  y = 0.f;
  if (row) {
    if (entry) {
      c = __ldg(c_ptr);
      v = __ldg(v_ptr);
    }
    if (ylane) y = __ldg(y_ptr);
  }
}

// Add one 32-entry chunk of a row into the warp's copy acc: lane a holds
// entry (c, v); yl is Y's value (ONE: the one column, on every lane; else
// lane j holds column q0 + j).
template <bool ONE>
__device__ __forceinline__ void xty_chunk(float* acc, int c0, int c1, int qc,
                                          int nq, int c, float v, float yl) {
  const int lane = threadIdx.x & 31;
  const bool nz = v != 0.f;
  bool live = nz && c >= c0 && c < c1;
  // Non-zero entries must be lanes 0.. with strictly increasing columns: a
  // non-zero lane after a zero one, or not above its left neighbour, fails.
  const int key = nz ? c : 0x7fffffff;
  const int left = __shfl_up_sync(FULL, key, 1);
  if (__any_sync(FULL, nz && lane > 0 && c <= left)) {
    const unsigned group = __match_any_sync(FULL, live ? c : -1 - lane);
    const int leader = __ffs(group) - 1;
    unsigned rest = lane == leader ? group & (group - 1) : 0u;
    while (__any_sync(FULL, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float x = __shfl_sync(FULL, v, src);
      if (rest) {
        v += x;
        rest &= rest - 1;
      }
    }
    live = live && lane == leader;
  }
  const int e = (c - c0) * qc;
  for (int j = 0; j < (ONE ? 1 : nq); ++j) {
    const float yj = ONE ? yl : __shfl_sync(FULL, yl, j);
    if (live) {
      float* a = acc + skew(e + j);
      *a = fmaf(v, yj, *a);
    }
  }
  __syncwarp();
}

template <bool WIDE, bool ONE>
__global__ void __launch_bounds__(GRAM_THREADS, 1)
spmm_xty_partials(const int* __restrict__ cols, const float* __restrict__ vals,
                  const float* __restrict__ y, float* __restrict__ ws,
                  int64_t n, int kmax, int ncol, int q, int qc, int cs,
                  int copy, int64_t rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = (q + qc - 1) / qc;
  const int c0 = (blockIdx.x / tq) * cs, c1 = min(ncol, c0 + cs);
  const int q0 = (blockIdx.x % tq) * qc, nq = min(qc, q - q0);
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  float* acc = smem + warp * copy;

  for (int e = threadIdx.x; e < warps * copy; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  // This warp's rows are r0 + warps·i, i < nr; ring slot s holds row i with
  // i % XTY_AHEAD == s.  f* point at the next row to fetch, r* at the row
  // being added (WIDE reads its later chunks there).
  const int64_t r0 = r_begin + warp;
  const int nr = r0 < r_end ? (int)((r_end - r0 + warps - 1) / warps) : 0;
  const int64_t step = (int64_t)warps * kmax, ystep = (int64_t)warps * q;
  const bool entry = lane < kmax, ylane = ONE || lane < nq;
  const int* fc = cols + r0 * kmax + lane;
  const float* fv = vals + r0 * kmax + lane;
  const float* fy = y + r0 * q + q0 + (ONE ? 0 : lane);
  const int* rc = fc;
  const float* rv = fv;
  int qcol[XTY_AHEAD];
  float qv[XTY_AHEAD], qy[XTY_AHEAD];
#pragma unroll
  for (int s = 0; s < XTY_AHEAD; ++s) {
    fetch_xty(s < nr, entry, ylane, fc, fv, fy, qcol[s], qv[s], qy[s]);
    fc += step;
    fv += step;
    fy += ystep;
  }
  for (int i0 = 0; i0 < nr; i0 += XTY_AHEAD) {
#pragma unroll
    for (int s = 0; s < XTY_AHEAD; ++s) {
      if (i0 + s >= nr) break;
      const int c = qcol[s];
      const float v = qv[s], yl = qy[s];
      fetch_xty(i0 + s + XTY_AHEAD < nr, entry, ylane, fc, fv, fy, qcol[s],
                qv[s], qy[s]);
      fc += step;
      fv += step;
      fy += ystep;
      xty_chunk<ONE>(acc, c0, c1, qc, nq, c, v, yl);
      if (WIDE) {
        for (int a0 = 32; a0 < kmax; a0 += 32) {
          int ca = -1;
          float va = 0.f;
          if (a0 + lane < kmax) {
            ca = __ldg(rc + a0);
            va = __ldg(rv + a0);
          }
          xty_chunk<ONE>(acc, c0, c1, qc, nq, ca, va, yl);
        }
      }
      rc += step;
      rv += step;
    }
  }
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)cs * qc;
  for (int e = threadIdx.x; e < cs * qc; e += blockDim.x) {
    const int k = skew(e);
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += smem[w * copy + k];
    out[e] = sum;
  }
}

// out (ncol, q) = Σ_s partial stripes: a warp an output element, lane l
// adding splits l, l + 32, … in order, then the lanes by a fixed shuffle
// tree (deterministic; 528 splits are 17 loads a lane, not 528 dependent
// ones).
__global__ void spmm_xty_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, int ncol, int q,
                                int qc, int cs, int64_t splits) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (e >= (int64_t)ncol * q) return;  // whole warps leave together
  const int i = (int)(e / q), j = (int)(e % q);
  const int tq = (q + qc - 1) / qc, tc = (ncol + cs - 1) / cs;
  const int64_t tt = (int64_t)cs * qc;
  const int64_t off = ((int64_t)(i / cs) * tq + j / qc) * tt
                      + (int64_t)(i % cs) * qc + (j % qc);
  float s = 0.f;
  for (int64_t k = lane; k < splits; k += 32) s += ws[k * tc * tq * tt + off];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(FULL, s, d);
  if (lane == 0) out[e] = s;
}

template <bool WIDE, bool ONE>
int launch_xty(const void* cols, const void* vals, const void* y, void* ws,
               void* out, int64_t n, int kmax, int ncol, int q, int qc, int cs,
               int warps, int64_t splits, cudaStream_t st) {
  if (warps < 1 || 32 * warps > GRAM_THREADS) return (int)cudaErrorInvalidValue;
  const int tiles = ((ncol + cs - 1) / cs) * ((q + qc - 1) / qc);
  const int copy = skew(cs * qc - 1) + 1;
  const int64_t smem = 4 * (int64_t)warps * copy;
  auto kern = spmm_xty_partials<WIDE, ONE>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((unsigned)tiles, (unsigned)splits);
  kern<<<grid, 32 * warps, smem, st>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(y), static_cast<float*>(ws), n, kmax, ncol, q,
      qc, cs, copy, rps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total_warps = (int64_t)ncol * q;  // one an output element
  spmm_xty_reduce<<<(unsigned)((total_warps + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), ncol, q, qc, cs,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws holds splits · nst(nst+1)/2 · ts² floats, nst = ceil(ncol / ts);
// ts² floats fit one block's shared memory.
int fm_spmm_gram(const void* cols, const void* vals, void* ws, void* out,
                 int64_t n, int kmax, int ncol, int ts, int64_t splits,
                 void* stream) {
  return kmax > 32 ? launch_gram<false, true>(cols, vals, nullptr, ws, out, n,
                                              kmax, ncol, ts, splits, stream)
                   : launch_gram<false, false>(cols, vals, nullptr, ws, out, n,
                                               kmax, ncol, ts, splits, stream);
}

// w is float32 (n,).
int fm_spmm_wgram(const void* cols, const void* vals, const void* w, void* ws,
                  void* out, int64_t n, int kmax, int ncol, int ts,
                  int64_t splits, void* stream) {
  return kmax > 32 ? launch_gram<true, true>(cols, vals, w, ws, out, n, kmax,
                                             ncol, ts, splits, stream)
                   : launch_gram<true, false>(cols, vals, w, ws, out, n, kmax,
                                              ncol, ts, splits, stream);
}

// y is float32 (n, q); ws holds splits · ceil(ncol/cs) · ceil(q/qc) · cs·qc
// floats; out is (ncol, q).  warps · (skew(cs·qc − 1) + 1) floats fit one
// block's shared memory (spmm.py xty_tile).
int fm_spmm_xty(const void* cols, const void* vals, const void* y, void* ws,
                void* out, int64_t n, int kmax, int ncol, int q, int qc, int cs,
                int warps, int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = kmax > 32, one = q == 1;
  auto go = wide ? (one ? launch_xty<true, true> : launch_xty<true, false>)
                 : (one ? launch_xty<false, true> : launch_xty<false, false>);
  return go(cols, vals, y, ws, out, n, kmax, ncol, q, qc, cs, warps, splits,
            st);
}

}  // extern "C"
