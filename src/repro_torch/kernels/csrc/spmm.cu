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
//       XᵀY: stripes of cs rows × qc columns.  Chunks of rows are copied
//     into shared memory with cp.async, double buffered; tpr threads take a
//     row, build bit masks of its entries in the stripe and add v_a·y_j.
//   launch 2 (*_reduce): one thread per output element sums the splits'
//     partial tiles in split order (and mirrors the I < J tiles).
//
// Shared-memory float atomics compile to compare-and-swap loops
// (ATOMS.CAST.SPIN) on sm_90a; at the Criteo shape spmm_gram makes about 390
// of them a row over its 28 tiles, and each tile reads every row once from
// L2 — these, not the slab's bytes, set its time.
//
// Accuracy: f32 throughout, as the reference.  A frequent level's entry sums
// millions of terms; each split's partial sums only its own rows (the wrapper
// caps rows per split and the workspace), and the splits are combined in a
// fixed order, so no single f32 accumulator takes all n rows.  Shared-memory
// atomics make the order inside a split vary from run to run.
//
// Zero entries (the padding) are skipped: for finite values they add
// nothing, and (col 0, val 0) padding would otherwise pile atomics onto
// column 0.  Column indices outside [0, ncol) fall in no tile and are
// dropped.  Offsets are 64-bit: n·kmax reaches 1.2e9 at Criteo scale.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staging buffers of one chunk: ch rows × kp (kmax rounded up to odd, so
// a warp reading one entry of 32 consecutive rows hits 32 banks) cols and
// vals, plus ch·ex floats of the row's weight (wgram) or of Y's columns (xty).
struct Stage {
  int* c;
  float* v;
  float* x;
};

__device__ __forceinline__ Stage stage_at(float* base, int buf, int ch, int kp,
                                          int ex) {
  const int64_t per = (int64_t)ch * (2 * kp + ex);
  float* b = base + buf * per;
  Stage st;
  st.c = reinterpret_cast<int*>(b);
  st.v = b + (int64_t)ch * kp;
  st.x = b + (int64_t)2 * ch * kp;
  return st;
}

// Issue the copies of rows [r0, r0 + rows) into a staging buffer.  Element
// e of the chunk is row e / kmax, entry e % kmax; a thread's elements step
// by THREADS, so its (row, entry) pair is advanced without dividing.
__device__ __forceinline__ void stage_rows(const int* __restrict__ cols,
                                           const float* __restrict__ vals,
                                           Stage st, int64_t r0, int rows,
                                           int kmax, int kp) {
  const int total = rows * kmax;
  const int64_t base = r0 * kmax;
  const int dr = THREADS / kmax, dk = THREADS % kmax;
  int rr = threadIdx.x / kmax, k = threadIdx.x % kmax;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    cp_async4(st.c + rr * kp + k, cols + base + e);
    cp_async4(st.v + rr * kp + k, vals + base + e);
    rr += dr;
    k += dk;
    if (k >= kmax) {
      k -= kmax;
      ++rr;
    }
  }
}

// Bits of the entries [a0, a0 + 32) of a staged row whose column lies in
// [lo, hi) and whose value is not zero; when tpr > 1 (a power of two: the
// row's entries shared out among its threads) only the entries a with
// a ≡ sub (mod tpr).
__device__ __forceinline__ unsigned row_mask(const int* rc, const float* rv,
                                             int a0, int kmax, int lo, int hi,
                                             int tpr, int sub) {
  unsigned m = 0;
  const int na = min(32, kmax - a0);
  for (int a = ((sub - a0) & (tpr - 1)); a < na; a += tpr) {
    const int c = rc[a0 + a];
    if (c >= lo && c < hi && rv[a0 + a] != 0.f) m |= 1u << a;
  }
  return m;
}

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

__global__ void __launch_bounds__(THREADS, 1)
spmm_xty_partials(const int* __restrict__ cols, const float* __restrict__ vals,
                  const float* __restrict__ y, float* __restrict__ ws,
                  int64_t n, int kmax, int ncol, int q, int qc, int cs,
                  int tpr, int64_t rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int ch = THREADS / tpr, kp = kmax | 1;
  float* acc = smem;
  float* stage_base = smem + cs * qc;

  const int tq = (q + qc - 1) / qc;
  const int c0 = (blockIdx.x / tq) * cs, c1 = min(ncol, c0 + cs);
  const int q0 = (blockIdx.x % tq) * qc, nq = min(qc, q - q0);
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const int rr = threadIdx.x % ch, sub = threadIdx.x / ch;

  for (int e = threadIdx.x; e < cs * qc; e += THREADS) acc[e] = 0.f;

  int buf = 0;
  for (int64_t r0 = r_begin - ch; r0 < r_end; r0 += ch) {
    // Stage the chunk after r0 (on the first pass, the first chunk), then
    // compute r0 once its copies have landed.
    const int64_t nx = r0 + ch;
    if (nx < r_end) {
      Stage st = stage_at(stage_base, r0 < r_begin ? 0 : buf ^ 1, ch, kp, qc);
      const int nrows = (int)min64(ch, r_end - nx);
      stage_rows(cols, vals, st, nx, nrows, kmax, kp);
      for (int e = threadIdx.x; e < nrows * nq; e += THREADS) {
        const int r = e / nq, j = e - r * nq;
        cp_async4(st.x + r * qc + j, y + (nx + r) * (int64_t)q + q0 + j);
      }
    }
    cp_async_commit();
    if (r0 < r_begin) continue;
    cp_async_wait<1>();
    __syncthreads();
    const int rows = (int)min64(ch, r_end - r0);
    if (rr < rows) {
      const Stage st = stage_at(stage_base, buf, ch, kp, qc);
      const int* rc = st.c + rr * kp;
      const float* rv = st.v + rr * kp;
      const float* ry = st.x + rr * qc;
      for (int a0 = 0; a0 < kmax; a0 += 32) {
        for (unsigned m = row_mask(rc, rv, a0, kmax, c0, c1, tpr, sub); m;
             m &= m - 1) {
          const int a = a0 + __ffs(m) - 1;
          const float va = rv[a];
          float* row = acc + (rc[a] - c0) * qc;
          for (int j = 0; j < nq; ++j) atomicAdd(row + j, va * ry[j]);
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)cs * qc;
  for (int e = threadIdx.x; e < cs * qc; e += THREADS) out[e] = acc[e];
}

// out (ncol, q) = Σ_s partial stripes, in split order.
__global__ void spmm_xty_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, int ncol, int q,
                                int qc, int cs, int64_t splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)ncol * q) return;
  const int i = (int)(e / q), j = (int)(e % q);
  const int tq = (q + qc - 1) / qc, tc = (ncol + cs - 1) / cs;
  const int64_t tile = (int64_t)(i / cs) * tq + j / qc;
  const int64_t tt = (int64_t)cs * qc;
  const int64_t off = tile * tt + (int64_t)(i % cs) * qc + (j % qc);
  float s = 0.f;
  for (int64_t k = 0; k < splits; ++k) s += ws[k * tc * tq * tt + off];
  out[e] = s;
}

int64_t smem_bytes(int acc_floats, int kmax, int tpr, int ex) {
  const int64_t ch = THREADS / tpr, kp = kmax | 1;
  return 4 * ((int64_t)acc_floats + 2 * ch * (2 * kp + ex));
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
// floats; out is (ncol, q).
int fm_spmm_xty(const void* cols, const void* vals, const void* y, void* ws,
                void* out, int64_t n, int kmax, int ncol, int q, int qc, int cs,
                int tpr, int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((ncol + cs - 1) / cs) * ((q + qc - 1) / qc);
  const int64_t smem = smem_bytes(cs * qc, kmax, tpr, qc);
  cudaError_t err = allow_smem(spmm_xty_partials, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((unsigned)tiles, (unsigned)splits);
  spmm_xty_partials<<<grid, THREADS, smem, st>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(y), static_cast<float*>(ws), n, kmax, ncol, q,
      qc, cs, tpr, rps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)ncol * q;
  spmm_xty_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), ncol, q, qc, cs,
      splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
