// Blockwise online-softmax ("flash") attention, forward, over
// q (B·nh, S, D) and k, v (B·nkv, T, D), f32 or bf16, into o (B·nh, S, D) in
// q's type; every sum in f32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_kernel, and
// computes its function: O = softmax(scale·QKᵀ + mask) V, masking by absolute
// ids (q_id >= k_id when causal, k_id < T always) with the finite -1e30, the
// running (m, l, acc) of the online softmax, l clamped at 1e-30 before the
// division.  The TPU kernel walked its kv grid axis in order with (m, l, acc)
// in VMEM scratch; here a block owns a q tile of one head and walks the kv
// tiles itself, (m, l, acc) in registers.  Two bodies, picked by the
// wrapper from the input type and head dim alone (a dispatch by shape;
// neither ever gives way to the other or to the plain version):
//
//   * bf16 at head dims 64 and 128 (the serving path: qwen2 64, llama and
//     granite 128): the Hopper body, namespace hopper below — TMA into an
//     mbarrier ring, QKᵀ and both terms of P·V on wgmma; its note has the
//     design.
//   * f32 inputs, and bf16 at the other head dims (16 and 32 in tests and
//     reduced configs; 80, 96, 112 and 256): the FMA body that follows, f32
//     throughout (bf16 values are widened as they are staged; their
//     products are exact in f32).  One block owns a 64-row q tile:
//
//   * S = QKᵀ of a 64 × 64 tile in f32 FMA: Q staged transposed, thread
//     (ty, tx) a 4 × 4 register tile fed by float4 shared loads.
//   * The softmax: 256 threads as 16 × 16, thread (ty, tx) owns rows
//     ty·4 .. +3 and keys tx + 16j (j < 4); the row max is a shuffle over
//     the 16 lanes of a half-warp, the row sum l stays a per-thread partial
//     until the end.  P goes to shared memory transposed.
//   * O += P·V in f32 FMA, as the Pallas kernel has it: thread (ty, tx)
//     owns rows ty·4 .. +3 and D/16 output columns, in chunks of VEC
//     adjacent columns read by one shared load, V staged as f32.
//   * Ragged S and T are masked while staging (zeros), never padded by a copy.
//   * GQA: block (b, h) reads K/V head b·nkv + h / g, so KV is never
//     repeated (g = 1 is the Pallas kernel's matched heads).  Both bodies.
//   * Causal: kv tiles wholly above the diagonal (first key > the tile's last
//     real query) are skipped — the same function, half the work.  The
//     heaviest q tiles are scheduled first (blockIdx.y counts down).  Both
//     bodies.
//   * Offsets are 64-bit: B·nh·S·D passes 2³¹ at the repo's prefill_32k.
//   * Shared memory: 86,016 bytes a block at D = 128: two blocks an SM;
//     153,600 at D = 256: one.  Row strides D + 4 floats keep every row
//     16-byte aligned at each D (a multiple of 16).
//
// Bound on the card: 2·B·nh·S²·D operations causal (4.12e11 at the serving
// path's B 4, 24 heads, S 4096, D 128) against 268 MB of bytes, so it is
// bound by operations: 0.42 ms at the bf16 tensor-core rate, 6.15 ms at the
// 67 TFLOP/s f32 rate.  The FMA body's P·V (half the work) runs at the f32
// rate, which bounds it at 3.1 ms; the Hopper body's split P·V bounds it
// at 0.63 ms.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include "hopper_async.cuh"  // mbarriers, TMA, the tensor map encoder

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;  // row stride of the transposed Q tile
constexpr int PS = BQ + 4;  // row stride of the transposed P tile
constexpr float NEG_INF = -1e30f;

// Bytes of shared memory a block of the FMA body uses (f32 tiles).
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * QS + (size_t)BK * (D + 4) + (size_t)BK * PS);
}

// 16 bytes of T from global memory as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}

// N consecutive floats from shared memory (N = 1, 2, 4; aligned to 4·N bytes).
template <int N>
__device__ __forceinline__ void ld_shared(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// Rows r0 .. r0+BK-1 of a head's (rows, D) matrix into shared memory as f32,
// row stride D + 4; rows at or past nrows are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int64_t r0,
                                           int64_t nrows, float* dst) {
  constexpr int VL = Vec<T>::N;
  constexpr int CPR = D / VL;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * VL;
    float v[VL];
    if (r0 + r < nrows) {
      Vec<T>::load(src + (r0 + r) * D + d0, v);
    } else {
#pragma unroll
      for (int e = 0; e < VL; ++e) v[e] = 0.f;
    }
    float* out = dst + r * (D + 4) + d0;
#pragma unroll
    for (int e = 0; e < VL; e += 4)
      *reinterpret_cast<float4*>(out + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

// Two blocks an SM fit in shared memory up to D = 128, one at D = 256 (whose
// registers the bound then leaves free).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int nh, int group, int64_t S, int64_t Tk, float scale,
          int causal, int n_qt) {
  constexpr int KS = D + 4;                  // f32 row stride of K / V
  constexpr int DC = D / 16;                 // output columns a thread
  // Output columns a thread per chunk: the largest of 4, 2, 1 dividing
  // D / 16, so that 16·VEC·NCH = D (VEC 1 at D 80 and 112, 2 at 96).
  constexpr int VEC = DC % 4 == 0 ? 4 : DC % 2 == 0 ? 2 : 1;
  constexpr int NCH = DC / VEC;              // chunks of 16·VEC columns
  static_assert(D % 16 == 0 && 16 * VEC * NCH == D, "head dim");
  extern __shared__ __align__(16) float smem[];
  // qt (D × QS, Q transposed) | kv (BK × KS: K, then V) | pt (BK × PS)
  float* qt = smem;
  float* kv = qt + D * QS;
  float* pt = kv + BK * KS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = lane & 15;
  const int ty = warp * 2 + (lane >> 4);
  const int64_t bh = blockIdx.x;
  const int64_t kvh = (bh / nh) * (nh / group) + (bh % nh) / group;
  const int64_t q0 = (int64_t)(n_qt - 1 - (int)blockIdx.y) * BQ;
  const T* qh = q + bh * S * D;
  const T* kh = k + kvh * Tk * D;
  const T* vh = v + kvh * Tk * D;

  // Q tile, transposed: qt[d][r]
  constexpr int VL = Vec<T>::N;
  constexpr int CPR = D / VL;
  for (int c = threadIdx.x; c < BQ * CPR; c += THREADS) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * VL;
    float x[VL];
    if (q0 + r < S) {
      Vec<T>::load(qh + (q0 + r) * D + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < VL; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VL; ++e) qt[(d0 + e) * QS + r] = x[e];
  }

  // kv tiles this q tile reads: causal stops at its last real query.
  int64_t kv_end = Tk;
  if (causal) {
    const int64_t q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
    kv_end = q_last + 1 < Tk ? q_last + 1 : Tk;
  }
  const int n_kt = (int)((kv_end + BK - 1) / BK);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = (int64_t)kt * BK;
    float s[4][4];  // S for rows ty·4+i, keys tx+16j
    __syncthreads();  // the last tile's P·V is done with kv and pt
    stage_rows<T, D>(kh, k0, Tk, kv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float qr[4][4], kr[4][4];  // qr[e][i] = Q[i][d+e], kr[j][e] = K[j][d+e]
#pragma unroll
      for (int e = 0; e < 4; ++e) ld_shared<4>(qt + (d + e) * QS + ty * 4, qr[e]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ld_shared<4>(kv + (tx + 16 * j) * KS + d, kr[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[e][i], kr[j][e], s[i][j]);
    }

    // Online softmax: scale, mask, new row max over the half-warp, rescale.
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + ty * 4 + i;
      mx[i] = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        const bool ok = kj < Tk && (!causal || qi >= kj);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * PS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done with K
    stage_rows<T, D>(vh, k0, Tk, kv);
    __syncthreads();  // P and V in place

    // acc += P V over the tile's keys, in key order.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
      ld_shared<4>(pt + kk * PS + ty * 4, p);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float vr[VEC];
        ld_shared<VEC>(kv + kk * KS + c * 16 * VEC + tx * VEC, vr);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][c * VEC + e] = fmaf(p[i], vr[e], acc[i][c * VEC + e]);
      }
    }
  }

  // l over the row's 16 threads, clamped; O = acc / l for the real rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int64_t qi = q0 + ty * 4 + i;
    if (qi < S) {
      T* orow = o + (bh * S + qi) * D;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          store_out(orow + c * 16 * VEC + tx * VEC + e, acc[i][c * VEC + e] / lt);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int nh,
           int group, int64_t S, int64_t Tk, float scale, int causal, void* stream) {
  auto kern = flash_fwd<T, D>;
  const size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (int)((S + BQ - 1) / BQ);
  const dim3 grid((unsigned)bh, (unsigned)n_qt);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nh, group, S, Tk, scale, causal, n_qt);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int nh,
             int group, int64_t S, int64_t Tk, int d, float scale, int causal,
             void* stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 80: return launch<T, 80>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 96: return launch<T, 96>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 112: return launch<T, 112>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The Hopper body: bf16 inputs at head dims 64 and 128.
//
// One block per (128-row q tile, q head), 384 threads: warpgroups 0 and 1
// consume (64 q rows each), warpgroup 2 produces (one thread issues TMA).
//   * Staging.  The producer loads Q once and then each kv tile (BK = 128
//     keys of K and of V) by TMA (cp.async.bulk.tensor, 3-D maps (D, rows,
//     heads) so ragged S and T zero-fill inside a head and never read the
//     next head) into a ring in shared memory, 2 stages at D = 128 and 4 at
//     D = 64; an mbarrier a stage says "full" (transaction bytes) and
//     another "empty" (the 256 consumer threads).  Boxes are 64 columns
//     (128 bytes, the swizzle's width) by 64 rows for Q and 128 for K / V,
//     128-byte swizzle; D = 128 is two boxes a row.  V stays bf16.  Each
//     K/V tile feeds 128 q rows.
//   * S = QKᵀ on wgmma m64n128k16, A = Q and B = K both from shared memory,
//     K-major, f32 accumulators in registers (no S tile in shared memory).
//   * Softmax on the accumulator layout: a thread holds 32 scores of each of
//     its two rows; the row max and sum take two quad shuffles.  For
//     scale > 0 (every model) the max is taken on the raw scores and
//     scale·log2 e is folded into exp2's FMA; any other scale takes an
//     instantiation that multiplies the scores first, so that zero and
//     negative scales mask as the Pallas kernel does (the fold saves one
//     FMUL a score: 1.24 against 1.31 ms at the serving shape on the
//     H100, PERF.md).  exp2 is ex2.approx (relative error about 2⁻²², far
//     below the bf16 output's 2⁻⁸).  The mask is by absolute id as in the
//     FMA body (q_id >= k_id when causal, k_id < T, finite -1e30) and runs
//     only on tiles that cross this warpgroup's diagonal or the ragged T
//     edge (TMA's zero fill gives scores of 0, not -inf).
//   * O += P·V as two products.  The Pallas kernel keeps P in f32; one
//     bf16 rounding of P would miss one bf16 ulp of the float64 output on
//     early rows (tests/test_torch_kernels.py shows it), so P goes to the
//     tensor cores as P_hi = bf16(P) and P_lo = bf16(P - P_hi), both built
//     in registers in wgmma's A-fragment layout (the S accumulator's layout
//     is that fragment's), and O += P_hi·V + P_lo·V with V from shared
//     memory MN-major (the transpose bit).  Products are exact in f32 (V is
//     bf16), sums f32; P keeps 16 of its 24 bits, its error ≤ 2⁻¹⁶·P.
//   * Epilogue: l over the row's four threads, clamped at 1e-30; O/l
//     rounded once to bf16 and stored from registers, rows past S masked.
//   * Causal: the block stops at its last real query's tile; warpgroup 0
//     skips the tiles wholly above its own rows.  Heaviest q tiles first.
//   * Registers: setmaxnreg gives the consumers 240 and the producer 24;
//     `-Xptxas -v` (_build/flash_attention.log) reports no spills.
//   * Each warpgroup runs S, softmax, P·V in turn.  Overlapping a tile's
//     softmax with tensor work (the next tile's QKᵀ issued before it, and
//     the two warpgroups taking turns at the tensor cores through named
//     barriers) gained a few percent at most on the H100, for a turn
//     protocol between the warpgroups (PERF.md); it is not done.
// Work: QKᵀ and P·V are B·nh·S²·D operations each when causal, and the
// split doubles P·V: 3·B·nh·S²·D, 1.5× the function's 4.12e11 at the
// serving shape, so this design's bound is 0.63 ms at the 989 TFLOP/s bf16
// rate, the function's 0.42 ms.  The tensor map encoder (a driver API
// function) is fetched with cudaGetDriverEntryPoint*, so the library links
// nothing beyond the CUDA runtime.

namespace hopper {

constexpr int WG_ROWS = 64;                  // q rows of a consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int BQ = WG_ROWS * CONSUMERS;      // q rows of a block
constexpr int BK = 128;                      // keys of a kv tile
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BOX = 64 * 64 * 2;             // bytes of a Q box: 64 rows × 64
constexpr int BOXK = BK * 64 * 2;            // bytes of a K or V box: BK rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DB = D / 64;                    // boxes a row
  static constexpr int STAGES = D == 128 ? 2 : 4;      // ring depth
  static constexpr int QTILE = DB * BOX;               // bytes of 64 q rows
  static constexpr int TILE = DB * BOXK;               // bytes of a K or V tile
  static constexpr int Q_BYTES = CONSUMERS * QTILE;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period.
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving register reads and writes across the
// asynchronous wgmma (the registers are in flight between issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major tiles: 8-row groups at
// 1024 bytes (SBO), LBO unused.  MN-major V: 8-key groups at 1024 bytes
// (SBO), 64-column boxes at BOX bytes (LBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (64 × 128) = A·B (scale_d 0) or D + A·B (scale_d 1): A (64 × 16) and
// B (16 × 128) both K-major in shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 × 64) += A·B: A (64 × 16) bf16 in registers (each warp's 16 rows
// as the m16n8k16 A fragment), B (16 × 64) MN-major in shared memory,
// 128-byte swizzle, read through the transpose bit.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 × 128) += A·B: A (64 × 16) bf16 in registers (each warp's 16 rows
// as the m16n8k16 A fragment), B (16 × 128) MN-major in shared memory,
// 128-byte swizzle, read through the transpose bit.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, db);
  else wgmma_m64n64k16_rs(o, a, db);
}

// q, o (B·nh, S, D); k, v (B·nkv, T, D) through the tensor maps tq, tk, tv.
// FOLD (scale > 0): the row max is taken on the raw scores and scale·log2 e
// folded into exp2's FMA; else the scores are scaled first.
template <int D, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int nh, int group, int64_t S, int64_t Tk, float scale_log2, int causal,
                int n_qt) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t bars = base + C::BAR_OFF;
  constexpr int STAGES = C::STAGES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t qbar = bars + 8u * (2 * STAGES);

  const int64_t bh = blockIdx.x;
  const int64_t kvh = (bh / nh) * (nh / group) + (bh % nh) / group;
  const int64_t q0 = (int64_t)(n_qt - 1 - (int)blockIdx.y) * BQ;
  int64_t kv_end = Tk;
  if (causal) {  // the block's last real query bounds its keys
    const int64_t q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
    kv_end = q_last + 1 < Tk ? q_last + 1 : Tk;
  }
  const int n_kt = (int)((kv_end + BK - 1) / BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int b = 0; b < C::DB; ++b)
          tma_load(sQ + w * C::QTILE + b * BOX, &tq, qbar, b * 64,
                   (int)(q0 + WG_ROWS * w), (int)bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, round = kt / STAGES;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::TILE);
        for (int b = 0; b < C::DB; ++b) {
          tma_load(sK + s * C::TILE + b * BOXK, &tk, full(s), b * 64, kt * BK, (int)kvh);
          tma_load(sV + s * C::TILE + b * BOXK, &tv, full(s), b * 64, kt * BK, (int)kvh);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: q rows qw .. qw + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int64_t qw = q0 + WG_ROWS * wg;
    // This thread's rows (accumulator layout): qr[0] and qr[0] + 8.
    const int64_t qr0 = qw + warp * 16 + lane / 4, qr1 = qr0 + 8;
    const int cq = (lane % 4) * 2;  // its first column in each 8-column group
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const uint32_t qtile = sQ + wg * C::QTILE;
    mbar_wait(qbar, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full(s), (kt / STAGES) & 1);
      const int64_t k0 = (int64_t)kt * BK;
      if (causal && k0 > qw + WG_ROWS - 1) {  // wholly above these rows
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t ktile = sK + s * C::TILE, vtile = sV + s * C::TILE;

      // S = Q Kᵀ over D in steps of 16 (32 bytes inside a 128-byte box row).
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into a 128-byte box row
        wgmma_m64n128k16_ss(sc, desc_sw128(qtile + (kk / 4) * BOX + col, 16, 1024),
                            desc_sw128(ktile + (kk / 4) * BOXK + col, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // Mask (scaled to log2 units first unless FOLD): register i holds
      // row qr0 (i & 2 == 0) or qr1, key k0 + (i / 4)·8 + cq + (i & 1);
      // then the row max, in log2 units.
      const bool edge = (causal && k0 + BK - 1 > qw) || k0 + BK > Tk;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float v = FOLD ? sc[i] : sc[i] * scale_log2;
        if (edge) {
          const int64_t kj = k0 + (i / 4) * 8 + cq + (i & 1);
          const int64_t qi = (i & 2) ? qr1 : qr0;
          if (kj >= Tk || (causal && qi < kj)) v = NEG_INF;
        }
        sc[i] = v;
        if (i & 2) mx1 = fmaxf(mx1, v);
        else mx0 = fmaxf(mx0, v);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if constexpr (FOLD) {
        mx0 *= scale_log2;
        mx1 *= scale_log2;
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float mn = (i & 2) ? mn1 : mn0;
        const float p = ex2(FOLD ? fmaf(sc[i], scale_log2, -mn) : sc[i] - mn);
        sc[i] = p;
        if (i & 2) ps1 += p;
        else ps0 += p;
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

      // P as two bf16 terms in the A-fragment layout: for keys 16j .. 16j+15,
      // a[0..3] = (S[8j], S[8j+1]), (S[8j+2], +3), (S[8j+4], +5), (S[8j+6], +7).
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = sc[8 * j + 2 * e], b = sc[8 * j + 2 * e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
          const float2 hf = __bfloat1622float2(hi);
          ph[j][e] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[j][e] = pack_bf16(a - hf.x, b - hf.y);
        }
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)  // 16 keys = two 8-row groups, 2048 bytes
        wgmma_pv<D>(acc, ph[j], desc_sw128(vtile + j * 2048, BOXK, 1024));
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_pv<D>(acc, pl[j], desc_sw128(vtile + j * 2048, BOXK, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

    // O = acc / l for the real rows, rounded once to bf16.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int64_t qi = (i & 2) ? qr1 : qr0;
      const float l = (i & 2) ? l1 : l0;
      if (qi < S) {
        const int col = (i / 4) * 8 + cq;
        *reinterpret_cast<__nv_bfloat162*>(o + (bh * S + qi) * D + col) =
            __floats2bfloat162_rn(acc[i] / l, acc[i + 1] / l);
      }
    }
  }
}

// A (D, rows, heads) bf16 map in 64 × 64 boxes with the 128-byte swizzle;
// out-of-range rows read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t heads, int d,
              int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int nh,
           int group, int64_t S, int64_t Tk, float scale, int causal, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, S, bh, D, WG_ROWS) || !make_map(&tk, k, Tk, bh / group, D, BK) ||
      !make_map(&tv, v, Tk, bh / group, D, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = scale > 0.f ? flash_fwd_wgmma<D, true> : flash_fwd_wgmma<D, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (int)((S + BQ - 1) / BQ);
  const dim3 grid((unsigned)bh, (unsigned)n_qt);
  kern<<<grid, THREADS, Cfg<D>::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), nh, group, S, Tk, scale * LOG2E,
      causal, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

extern "C" {

// The FMA body.  q, o: (bh, S, d) with bh = B·nh; k, v: (B·nh/group, T,
// d); all contiguous and 16-byte aligned, d ∈ {16, 32, 64, 80, 96, 112,
// 128, 256}, float32 (dtype 0) or bfloat16 (dtype 1; d 64 and 128 take
// fm_flash_attention_wgmma).  S ≥ 1, T ≥ 1, ceil(S / 64) ≤ 65535.
int fm_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                       int nh, int group, int64_t S, int64_t Tk, int d, float scale,
                       int causal, int dtype, void* stream) {
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bh, nh, group, S, Tk, d, scale, causal, stream);
  if (d == 64 || d == 128) return (int)cudaErrorInvalidValue;  // the wgmma body's
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, nh, group, S, Tk, d, scale, causal,
                                 stream);
}

// The Hopper body (namespace hopper): q, k, v, o bfloat16, d ∈ {64, 128};
// otherwise as fm_flash_attention, with ceil(S / 128) ≤ 65535.
int fm_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                             int bh, int nh, int group, int64_t S, int64_t Tk, int d,
                             float scale, int causal, void* stream) {
  switch (d) {
    case 64: return hopper::launch<64>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    case 128: return hopper::launch<128>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
