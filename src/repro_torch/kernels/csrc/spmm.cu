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
//   launch 1 (*_partials): grid (tiles, splits).  The output is cut into
//     tiles that fit in shared memory — for XᵀX/XᵀWX square tiles (I, J) of
//     ts×ts with I ≤ J (the rest is the mirror image), for XᵀY stripes of cs
//     rows × qc columns.  Block (t, s) owns tile t over the row range of split
//     s: chunks of rows are copied into shared memory with cp.async, double
//     buffered (the next chunk is in flight while this one is computed); each
//     row is taken by tpr threads, each of which builds bit masks of the
//     row's entries that fall in the tile's row range (its own share of them)
//     and column range, and adds v_a·v_b (·w_r) for every pair of set bits
//     into the tile with shared-memory atomics.  The blocks of one split are
//     launched next to each other, so they read the same rows from L2 at
//     about the same time: the slab comes from device memory about once.
//   launch 2 (*_reduce): one thread per output element sums the splits'
//     partial tiles in split order (and mirrors the I < J tiles).
//
// Shared-memory float atomics compile to compare-and-swap loops
// (ATOMS.CAST.SPIN) on sm_90a; at the Criteo shape spmm_gram makes about 380
// of them a row, and each block scans its rows' masks once per tile — these,
// not the slab's bytes, set its time.
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

template <bool WEIGHTED>
__global__ void __launch_bounds__(THREADS, 1)
spmm_gram_partials(const int* __restrict__ cols, const float* __restrict__ vals,
                   const float* __restrict__ w, float* __restrict__ ws,
                   int64_t n, int kmax, int ncol, int ts, int nst, int tpr,
                   int64_t rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int ch = THREADS / tpr, kp = kmax | 1, ex = WEIGHTED ? 1 : 0;
  float* acc = smem;
  float* stage_base = smem + ts * ts;

  int I, J;
  tile_of(blockIdx.x, nst, I, J);
  const int i0 = I * ts, i1 = min(ncol, i0 + ts);
  const int j0 = J * ts, j1 = min(ncol, j0 + ts);
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const int rr = threadIdx.x % ch, sub = threadIdx.x / ch;

  for (int e = threadIdx.x; e < ts * ts; e += THREADS) acc[e] = 0.f;

  int buf = 0;
  if (r_begin < r_end) {
    Stage st = stage_at(stage_base, 0, ch, kp, ex);
    const int rows = (int)min64(ch, r_end - r_begin);
    stage_rows(cols, vals, st, r_begin, rows, kmax, kp);
    if (WEIGHTED)
      for (int e = threadIdx.x; e < rows; e += THREADS)
        cp_async4(st.x + e, w + r_begin + e);
  }
  cp_async_commit();
  for (int64_t r0 = r_begin; r0 < r_end; r0 += ch) {
    const int rows = (int)min64(ch, r_end - r0);
    const int64_t nx = r0 + ch;
    if (nx < r_end) {
      Stage st = stage_at(stage_base, buf ^ 1, ch, kp, ex);
      const int nrows = (int)min64(ch, r_end - nx);
      stage_rows(cols, vals, st, nx, nrows, kmax, kp);
      if (WEIGHTED)
        for (int e = threadIdx.x; e < nrows; e += THREADS)
          cp_async4(st.x + e, w + nx + e);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (rr < rows) {
      const Stage st = stage_at(stage_base, buf, ch, kp, ex);
      const int* rc = st.c + rr * kp;
      const float* rv = st.v + rr * kp;
      const float wr = WEIGHTED ? st.x[rr] : 1.f;
      for (int a0 = 0; a0 < kmax; a0 += 32) {
        const unsigned ma = row_mask(rc, rv, a0, kmax, i0, i1, tpr, sub);
        if (!ma) continue;
        for (int b0 = 0; b0 < kmax; b0 += 32) {
          const unsigned mb = row_mask(rc, rv, b0, kmax, j0, j1, 1, 0);
          if (!mb) continue;
          for (unsigned m = ma; m; m &= m - 1) {
            const int a = a0 + __ffs(m) - 1;
            const float va = rv[a] * wr;
            float* row = acc + (rc[a] - i0) * ts - j0;
            for (unsigned mm = mb; mm; mm &= mm - 1) {
              const int b = b0 + __ffs(mm) - 1;
              atomicAdd(row + rc[b], va * rv[b]);
            }
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = ws + (split * gridDim.x + blockIdx.x) * (int64_t)ts * ts;
  for (int e = threadIdx.x; e < ts * ts; e += THREADS) out[e] = acc[e];
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

template <bool WEIGHTED>
int launch_gram(const void* cols, const void* vals, const void* w, void* ws,
                void* out, int64_t n, int kmax, int ncol, int ts, int tpr,
                int64_t splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nst = (ncol + ts - 1) / ts;
  const int ntiles = nst * (nst + 1) / 2;
  const int64_t smem = smem_bytes(ts * ts, kmax, tpr, WEIGHTED ? 1 : 0);
  auto kern = spmm_gram_partials<WEIGHTED>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((unsigned)ntiles, (unsigned)splits);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<float*>(ws), n, kmax, ncol, ts,
      nst, tpr, rps);
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

// ws holds splits · nst(nst+1)/2 · ts² floats, nst = ceil(ncol / ts).
int fm_spmm_gram(const void* cols, const void* vals, void* ws, void* out,
                 int64_t n, int kmax, int ncol, int ts, int tpr, int64_t splits,
                 void* stream) {
  return launch_gram<false>(cols, vals, nullptr, ws, out, n, kmax, ncol, ts,
                            tpr, splits, stream);
}

// w is float32 (n,).
int fm_spmm_wgram(const void* cols, const void* vals, const void* w, void* ws,
                  void* out, int64_t n, int kmax, int ncol, int ts, int tpr,
                  int64_t splits, void* stream) {
  return launch_gram<true>(cols, vals, w, ws, out, n, kmax, ncol, ts, tpr,
                           splits, stream);
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
