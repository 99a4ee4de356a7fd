// Blockwise online-softmax ("flash") attention, forward, over
// q (B·nh, S, D) and k, v (B·nkv, T, D), f32 or bf16, into o (B·nh, S, D) in
// q's type; every sum in f32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_kernel, and
// computes its function: O = softmax(scale·QKᵀ + mask) V, masking by absolute
// ids (q_id >= k_id when causal, k_id < T always) with the finite -1e30, the
// running (m, l, acc) of the online softmax, l clamped at 1e-30 before the
// division.  The TPU kernel walked its kv grid axis in order with (m, l, acc)
// in VMEM scratch; here one block owns a 64-row q tile of one head and walks
// the kv tiles itself, (m, l, acc) in registers:
//
//   * S = QKᵀ of a 64 × 64 tile: for bf16 inputs on the tensor cores
//     (mma.sync m16n8k16, bf16 products exact in f32, f32 sums: the same
//     arithmetic up to the order of the sum), each of the 8 warps a 16 × 32
//     piece, Q and K staged as bf16 rows; for f32 inputs in f32 FMA, Q staged
//     transposed, thread (ty, tx) a 4 × 4 register tile fed by float4 shared
//     loads.
//   * The softmax runs in one layout for both: 256 threads as 16 × 16,
//     thread (ty, tx) owns rows ty·4 .. +3 and keys tx + 16j (j < 4); the row
//     max is a shuffle over the 16 lanes of a half-warp, the row sum l stays a
//     per-thread partial until the end.  P goes to shared memory transposed.
//   * O += P·V stays f32 FMA, as the Pallas kernel has it: thread (ty, tx)
//     owns rows ty·4 .. +3 and D/16 output columns, V staged as f32.
//   * Ragged S and T are masked while staging (zeros), never padded by a copy.
//   * GQA: block (b, h) reads K/V head b·nkv + h / g, so KV is never
//     repeated (g = 1 is the Pallas kernel's matched heads).
//   * Causal: kv tiles wholly above the diagonal (first key > the tile's last
//     real query) are skipped — the same function, half the work.  The
//     heaviest q tiles are scheduled first (blockIdx.y counts down).
//   * Offsets are 64-bit: B·nh·S·D passes 2³¹ at the repo's prefill_32k.
//   * Shared memory: 103,424 bytes a block at D = 128 in bf16, 86,016 in
//     f32: two blocks an SM.
//
// Bound on the card: 2·B·nh·S²·D operations causal (4.12e11 at the serving
// path's B 4, 24 heads, S 4096, D 128) against 268 MB of bytes, so it is
// bound by operations: 0.42 ms at the bf16 tensor-core rate, 6.15 ms at the
// 67 TFLOP/s f32 rate.  Half of the work (P·V) is f32 FMA here, so the f32
// rate bounds this design at 3.1 ms; wgmma, and P·V on the tensor cores once
// its precision is argued, are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;  // row stride of the transposed Q tile (f32 path)
constexpr int PS = BQ + 4;  // row stride of the transposed P tile
constexpr int SS = BK + 4;  // row stride of the S tile (bf16 path)
constexpr float NEG_INF = -1e30f;

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

// Bytes of shared memory a block uses.
template <typename T, int D>
constexpr size_t smem_bytes() {
  if constexpr (kMma<T>) {
    return 2 * (size_t)2 * BQ * (D + 8)                 // Q, K bf16 rows
           + sizeof(float) * ((size_t)BK * (D + 4)      // V f32 rows
                              + (size_t)BQ * SS + (size_t)BK * PS);
  } else {
    return sizeof(float) * ((size_t)D * QS + (size_t)BK * (D + 4) + (size_t)BK * PS);
  }
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

// Rows r0 .. r0+64-1 of a bf16 (rows, D) matrix into shared memory as they
// are, row stride D + 8 (16-byte rows, conflict-free fragment loads); rows at
// or past nrows are zeros.
template <int D>
__device__ __forceinline__ void stage_raw(const __nv_bfloat16* __restrict__ src,
                                          int64_t r0, int64_t nrows,
                                          __nv_bfloat16* dst) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR;
    const int d0 = (c % CPR) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) u = *reinterpret_cast<const uint4*>(src + (r0 + r) * D + d0);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + d0) = u;
  }
}

// D += A·B for one m16n8k16 tile: A (16 × 16) row-major, B (16 × 8)
// column-major, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int nh, int group, int64_t S, int64_t Tk, float scale,
          int causal, int n_qt) {
  constexpr bool MMA = kMma<T>;
  constexpr int KS = D + 4;                  // f32 row stride of K / V
  constexpr int RS = D + 8;                  // bf16 row stride of Q / K (MMA)
  constexpr int VEC = D >= 64 ? 4 : D / 16;  // output columns a thread per chunk
  constexpr int NCH = D / (16 * VEC);        // chunks of 16·VEC columns
  constexpr int DC = VEC * NCH;              // = D / 16 output columns a thread
  extern __shared__ __align__(16) float smem[];
  // f32 path: qt (D × QS, Q transposed) | kv (BK × KS: K, then V) | pt
  // bf16 path: qb, kb (64 × RS bf16 each) | kv (BK × KS: V) | st (BQ × SS) | pt
  float* qt = smem;
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kb = qb + BQ * RS;
  float* kv = MMA ? reinterpret_cast<float*>(kb + BK * RS) : qt + D * QS;
  float* st = kv + BK * KS;
  float* pt = MMA ? st + BQ * SS : kv + BK * KS;

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

  if constexpr (MMA) {
    stage_raw<D>(qh, q0, S, qb);
  } else {  // Q tile, transposed: qt[d][r]
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
    if constexpr (MMA) {
      stage_raw<D>(kh, k0, Tk, kb);
      stage_rows<T, D>(vh, k0, Tk, kv);
      __syncthreads();
      // Warp w: rows (w % 4)·16, keys (w / 4)·32 .. +31 as four n8 tiles.
      const int g = lane >> 2, t4 = lane & 3;
      const int rb = (warp & 3) * 16, cb = (warp >> 2) * 32;
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 16) {
        const __nv_bfloat16* qa = qb + (rb + g) * RS + d + t4 * 2;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * RS), ld_pair(qa + 8),
                               ld_pair(qa + 8 * RS + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const __nv_bfloat16* kp = kb + (cb + n * 8 + g) * RS + d + t4 * 2;
          mma_bf16(c[n], a, ld_pair(kp), ld_pair(kp + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* sp = st + (rb + g) * SS + cb + n * 8 + t4 * 2;
        *reinterpret_cast<float2*>(sp) = make_float2(c[n][0], c[n][1]);
        *reinterpret_cast<float2*>(sp + 8 * SS) = make_float2(c[n][2], c[n][3]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = st[(ty * 4 + i) * SS + tx + 16 * j];
    } else {
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
    if constexpr (!MMA) {
      __syncthreads();  // every thread is done with K
      stage_rows<T, D>(vh, k0, Tk, kv);
    }
    __syncthreads();  // P (and V) in place

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
  const size_t smem = smem_bytes<T, D>();
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
    case 128: return launch<T, 128>(q, k, v, o, bh, nh, group, S, Tk, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (bh, S, d) with bh = B·nh; k, v: (B·nh/group, T, d); all contiguous,
// float32 (dtype 0) or bfloat16 (dtype 1).  d ∈ {16, 32, 64, 128}; S ≥ 1,
// T ≥ 1, ceil(S / 64) ≤ 65535.
int fm_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                       int nh, int group, int64_t S, int64_t Tk, int d, float scale,
                       int causal, int dtype, void* stream) {
  return dtype == 0
      ? dispatch<float>(q, k, v, o, bh, nh, group, S, Tk, d, scale, causal, stream)
      : dispatch<__nv_bfloat16>(q, k, v, o, bh, nh, group, S, Tk, d, scale, causal,
                                stream);
}

}  // extern "C"
