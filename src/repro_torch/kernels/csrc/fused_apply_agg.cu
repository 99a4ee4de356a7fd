// Fused apply→aggregate: N chains of unary VUDFs, each followed by a column
// aggregation, from ONE read of a tall row-major X (n, p).  Two bodies share
// the chain interpreter (apply_step) and the combine launch: the ring body
// (chain_ring_partials, p ≤ 256, the main path; its note is further down)
// and the tile body described here (p > 256).
//
// Replaces the Pallas kernel repro/kernels/fused_apply_agg.py:_chain_kernel.
// The chain spec arrives as a small int program built on the host
// (repro_torch/kernels/fused_apply_agg.py): per chain its steps' opcodes and
// the value type at each step (int32, f32, or bf16 — the JAX chain changes
// type at sqrt, cast_*, ...), its aggregation and its accumulator type.  The
// program travels by value as a kernel parameter, so every thread reads it
// from the constant bank and the branches on it are uniform.
//
//   launch 1 (chain_partials, the tile body): grid (column tiles of 32, row
//     splits), block 32×8.  Neighbouring threads take neighbouring columns of one row, so a
//     warp reads a row's 128 bytes at once; the 8 row lanes walk the split's
//     rows, 4 rows a thread at a time, so each chain step is decoded once
//     for 4 values.  Each thread keeps one accumulator per chain in registers
//     (chains are unrolled, at most MAX_CHAINS a launch), the 8 lanes reduce
//     in shared memory in a fixed order, and the block's partials go to the
//     workspace.
//   launch 2 (chain_combine): one thread per (chain, column) combines the
//     splits' partials in split order — deterministic, no atomics.
//
// A bfloat16 X is widened to f32 as it is loaded (exactly), so it is read at
// its own 2 bytes an element.
//
// min/max start from ±inf or the int32 extrema and propagate NaN like
// jnp.minimum/jnp.maximum (fminf/fmaxf do not; the tile body tests for NaN
// per value, the ring body uses the NaN-propagating min.NaN / max.NaN).
// Bound: the one read of X; the chain interpretation costs instructions per
// element, which both bodies spend instead of specialising per chain spec.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper_async.cuh"  // mbar_*, bulk_load

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int MAX_CHAINS = 8;
constexpr int MAX_STEPS = 16;
constexpr int TX = 32, TY = 8;

enum Type { T_INT = 0, T_F32 = 1, T_BF16 = 2 };
enum Op {
  OP_IDENTITY = 0, OP_ABS, OP_SQ, OP_SQRT, OP_EXP, OP_LOG, OP_LOG1P, OP_NEG,
  OP_SIGMOID, OP_FLOOR, OP_CEIL, OP_ROUND, OP_SIGN, OP_CAST_F32, OP_CAST_I32,
  OP_CAST_BF16
};
enum Agg { AGG_SUM = 0, AGG_MIN, AGG_MAX, AGG_COUNT, AGG_NNZ };

struct ChainProg {
  int n_chains;
  int src_type;  // what X holds: int32, float32 or bfloat16 (enum Type)
  int nsteps[MAX_CHAINS];
  int start_type[MAX_CHAINS];
  int agg[MAX_CHAINS];
  int acc_int[MAX_CHAINS];
  int ops[MAX_CHAINS][MAX_STEPS];
  int types[MAX_CHAINS][MAX_STEPS];  // value type entering each step
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One step of a chain applied to the V values a thread holds, all of type t;
// returns the new type.  The op is uniform across the block, so the switch is
// decided once per step and the element loops inside it are straight code.
template <int V>
__device__ __forceinline__ int apply_step(int op, int t, float (&f)[V], int (&i)[V]) {
  if (op == OP_CAST_F32) {
    if (t == T_INT) {
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = (float)i[v];
    }
    return T_F32;
  }
  if (op == OP_CAST_I32) {
    if (t != T_INT) {
#pragma unroll
      for (int v = 0; v < V; ++v) i[v] = __float2int_rz(f[v]);
    }
    return T_INT;
  }
  if (op == OP_CAST_BF16) {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = bf16_round(t == T_INT ? (float)i[v] : f[v]);
    return T_BF16;
  }
  if (t == T_INT) {
    switch (op) {
      case OP_ABS:
#pragma unroll
        for (int v = 0; v < V; ++v) i[v] = i[v] < 0 ? (int)(0u - (unsigned)i[v]) : i[v];
        return T_INT;
      case OP_SQ:
#pragma unroll
        for (int v = 0; v < V; ++v) i[v] = (int)((unsigned)i[v] * (unsigned)i[v]);
        return T_INT;
      case OP_NEG:
#pragma unroll
        for (int v = 0; v < V; ++v) i[v] = (int)(0u - (unsigned)i[v]);
        return T_INT;
      case OP_SIGN:
#pragma unroll
        for (int v = 0; v < V; ++v) i[v] = (i[v] > 0) - (i[v] < 0);
        return T_INT;
      case OP_SQRT: case OP_EXP: case OP_LOG: case OP_LOG1P: case OP_SIGMOID:
#pragma unroll
        for (int v = 0; v < V; ++v) f[v] = (float)i[v];
        t = T_F32;  // the float op below
        break;
      default:
        return T_INT;  // identity, floor, ceil, round
    }
  }
  switch (op) {
#define FM_EACH(expr) _Pragma("unroll") for (int v = 0; v < V; ++v) { const float x = f[v]; f[v] = (expr); } break;
    case OP_ABS: FM_EACH(fabsf(x))
    case OP_SQ: FM_EACH(x * x)
    case OP_SQRT: FM_EACH(sqrtf(x))
    case OP_EXP: FM_EACH(expf(x))
    case OP_LOG: FM_EACH(logf(x))
    case OP_LOG1P: FM_EACH(log1pf(x))
    case OP_NEG: FM_EACH(-x)
    case OP_SIGMOID: FM_EACH(1.0f / (1.0f + expf(-x)))
    case OP_FLOOR: FM_EACH(floorf(x))
    case OP_CEIL: FM_EACH(ceilf(x))
    case OP_ROUND: FM_EACH(rintf(x))  // half to even, as jnp.round
    case OP_SIGN: FM_EACH(x > 0.f ? 1.f : (x < 0.f ? -1.f : x))  // keeps ±0, NaN
#undef FM_EACH
    default: break;
  }
  if (t == T_BF16) {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = bf16_round(f[v]);
  }
  return t;
}

constexpr int RV = 4;  // rows a thread holds at once

__global__ void __launch_bounds__(TX * TY)
chain_partials(const void* __restrict__ xv, uint32_t* __restrict__ ws,
               int64_t n, int p, int64_t rows_per_split, const ChainProg prog) {
  __shared__ uint32_t red[TY][MAX_CHAINS][TX];
  const int col = blockIdx.x * TX + threadIdx.x;
  const int64_t split = blockIdx.y;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const float* xf_ptr = static_cast<const float*>(xv);
  const int* xi_ptr = static_cast<const int*>(xv);
  const __nv_bfloat16* xb_ptr = static_cast<const __nv_bfloat16*>(xv);
  const bool src_int = prog.src_type == T_INT;

  float af[MAX_CHAINS];
  int ai[MAX_CHAINS];
#pragma unroll
  for (int c = 0; c < MAX_CHAINS; ++c) {
    const int a = prog.agg[c];
    af[c] = a == AGG_MIN ? INFINITY : (a == AGG_MAX ? -INFINITY : 0.f);
    ai[c] = a == AGG_MIN ? INT32_MAX : (a == AGG_MAX ? INT32_MIN : 0);
  }

  if (col < p) {
    for (int64_t r0 = r_begin + threadIdx.y; r0 < r_end; r0 += TY * RV) {
      // RV rows r0, r0 + TY, ...: independent loads in flight together.
      float xf[RV];
      int xi[RV];
      bool ok[RV];
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        const int64_t r = r0 + (int64_t)v * TY;
        ok[v] = r < r_end;
        xf[v] = 0.f;
        xi[v] = 0;
        if (ok[v]) {
          const int64_t idx = r * (int64_t)p + col;
          if (src_int) xi[v] = xi_ptr[idx];
          else if (prog.src_type == T_BF16) xf[v] = __bfloat162float(xb_ptr[idx]);
          else xf[v] = xf_ptr[idx];
        }
      }
#pragma unroll
      for (int c = 0; c < MAX_CHAINS; ++c) {
        if (c >= prog.n_chains) break;
        int t = prog.start_type[c];
        float f[RV];
        int i[RV];
#pragma unroll
        for (int v = 0; v < RV; ++v) {
          f[v] = src_int ? (float)xi[v] : xf[v];
          i[v] = xi[v];
        }
        for (int s = 0; s < prog.nsteps[c]; ++s)
          t = apply_step<RV>(prog.ops[c][s], prog.types[c][s], f, i);
        const int a = prog.agg[c];
        const bool acc_int = prog.acc_int[c];
#pragma unroll
        for (int v = 0; v < RV; ++v) {
          if (!ok[v]) continue;
          if (a == AGG_COUNT) {
            if (acc_int) ai[c] += 1; else af[c] += 1.f;
          } else if (a == AGG_NNZ) {
            const bool nz = (t == T_INT) ? (i[v] != 0) : (f[v] != 0.f);
            if (acc_int) ai[c] += nz; else af[c] += nz ? 1.f : 0.f;
          } else if (acc_int) {
            const int x = (t == T_INT) ? i[v] : __float2int_rz(f[v]);
            if (a == AGG_SUM) ai[c] = (int)((unsigned)ai[c] + (unsigned)x);
            else if (a == AGG_MIN) ai[c] = min(ai[c], x);
            else ai[c] = max(ai[c], x);
          } else {
            const float x = (t == T_INT) ? (float)i[v] : f[v];
            if (a == AGG_SUM) af[c] += x;
            else if (a == AGG_MIN) af[c] = nan_min(af[c], x);
            else af[c] = nan_max(af[c], x);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < MAX_CHAINS; ++c)
    red[threadIdx.y][c][threadIdx.x] =
        prog.acc_int[c] ? (uint32_t)ai[c] : __float_as_uint(af[c]);
  __syncthreads();
  if (threadIdx.y != 0 || col >= p) return;
  for (int c = 0; c < prog.n_chains; ++c) {
    const int a = prog.agg[c];
    uint32_t out;
    if (prog.acc_int[c]) {
      int v = (int)red[0][c][threadIdx.x];
      for (int y = 1; y < TY; ++y) {
        const int u = (int)red[y][c][threadIdx.x];
        if (a == AGG_MIN) v = min(v, u);
        else if (a == AGG_MAX) v = max(v, u);
        else v = (int)((unsigned)v + (unsigned)u);
      }
      out = (uint32_t)v;
    } else {
      float v = __uint_as_float(red[0][c][threadIdx.x]);
      for (int y = 1; y < TY; ++y) {
        const float u = __uint_as_float(red[y][c][threadIdx.x]);
        if (a == AGG_MIN) v = nan_min(v, u);
        else if (a == AGG_MAX) v = nan_max(v, u);
        else v += u;
      }
      out = __float_as_uint(v);
    }
    ws[(split * prog.n_chains + c) * (int64_t)p + col] = out;
  }
}

__global__ void chain_combine(const uint32_t* __restrict__ ws,
                              uint32_t* __restrict__ out, int p, int64_t splits,
                              const ChainProg prog) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= prog.n_chains * p) return;
  const int c = e / p;
  const int a = prog.agg[c];
  const int64_t stride = (int64_t)prog.n_chains * p;
  if (prog.acc_int[c]) {
    int v = (int)ws[e];
    for (int64_t s = 1; s < splits; ++s) {
      const int u = (int)ws[s * stride + e];
      if (a == AGG_MIN) v = min(v, u);
      else if (a == AGG_MAX) v = max(v, u);
      else v = (int)((unsigned)v + (unsigned)u);
    }
    out[e] = (uint32_t)v;
  } else {
    float v = __uint_as_float(ws[e]);
    for (int64_t s = 1; s < splits; ++s) {
      const float u = __uint_as_float(ws[s * stride + e]);
      if (a == AGG_MIN) v = nan_min(v, u);
      else if (a == AGG_MAX) v = nan_max(v, u);
      else v += u;
    }
    out[e] = __float_as_uint(v);
  }
}


// ---------------------------------------------------------------------------
// The ring body (chain_ring_partials), p ≤ 256: the main path (summary()'s
// six chains over Friendster-32, p = 32 f32).  Its bound is the one read of
// X (8.4 GB, 2.51 ms at 3.35 TB/s); the tile body missed it 8× with 16 KB
// of loads in flight an SM, nothing in flight while the chains ran, and the
// chain program decoded for every 4 values.  Here
//   * the block takes all p columns, so a split's rows are one contiguous
//     slab: thread 0 bulk-copies (cp.async.bulk) chunks of R rows into an
//     mbarrier ring of `stages` stages of about 32 KB, so stages − 1 chunks
//     are in flight while one is interpreted (two blocks an SM: up to 128 KB
//     an SM) and no register holds a load.  R · p · elem is a multiple of
//     16 bytes and rows_per_split a multiple of R, so every full chunk starts
//     16-byte aligned when X does (the wrapper copies a base that does not);
//     the split's last, partial chunk is read with plain loads;
//   * L = ⌊256 / p⌋ row lanes: thread t owns column t mod p in lane t / p
//     (threads past L·p idle), so a warp reads consecutive words of the
//     flat chunk — conflict-free at any p — and one column's accumulators
//     stay in one thread's registers;
//   * each thread reads V = RING_V = 16 values of its column (rows r, r + L,
//     …) from the stage, then runs every chain on them: the step's switch and
//     the aggregation's branch on (agg, accumulator, final type) are taken
//     once for V values, and a chain with no step aggregates the values as
//     read (no register copies); a full chunk is a whole number of
//     V-groups, so its loop has no row mask — only the tail's has;
//   * min / max propagate NaN by min.NaN.f32 / max.NaN.f32 (one instruction,
//     NaN if either operand is), not a per-value test;
//   * lanes are added in lane order, blocks in split order (chain_combine):
//     deterministic bit for bit, no atomics.
// Geometry (R, stages, splits) is fused_apply_agg.py's chain_plan, a
// function of (n, p, dtype) alone.
constexpr int RING_THREADS = 256;
constexpr int RING_V = 16;     // values of a column whose chains run together
constexpr int RING_BARS = 64;  // bytes before the ring: one mbarrier a stage (≤ 8)

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int SRC> __host__ __device__ constexpr int src_bytes() {
  return SRC == T_BF16 ? 2 : 4;
}

// Element e of a stage, widened as the tile body widens its loads: an int32
// source gives (f, i) = ((float)i, i), a float one (f, 0).
template <int SRC>
__device__ __forceinline__ void stage_value(const unsigned char* st, int e, float& f,
                                            int& i) {
  if (SRC == T_BF16) {
    f = __uint_as_float((uint32_t)reinterpret_cast<const unsigned short*>(st)[e] << 16);
    i = 0;
  } else if (SRC == T_F32) {
    f = reinterpret_cast<const float*>(st)[e];
    i = 0;
  } else {
    i = reinterpret_cast<const int*>(st)[e];
    f = (float)i;
  }
}

// V values of type t into one chain's accumulator; the branch on (agg,
// accumulator, t) is taken once for the V values.  MASK: only ok[v] count.
template <bool MASK, int V>
__device__ __forceinline__ void aggregate(int a, bool acc_int, int t, const float (&f)[V],
                                          const int (&i)[V], const bool (&ok)[V],
                                          float& af, int& ai) {
  if (a == AGG_COUNT || a == AGG_NNZ) {
    int cnt = 0;
    if (a == AGG_COUNT) {
#pragma unroll
      for (int v = 0; v < V; ++v) cnt += !MASK || ok[v];
    } else if (t == T_INT) {
#pragma unroll
      for (int v = 0; v < V; ++v) cnt += (!MASK || ok[v]) && i[v] != 0;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) cnt += (!MASK || ok[v]) && f[v] != 0.f;
    }
    if (acc_int) ai += cnt;
    else af += (float)cnt;  // exact: a thread counts far fewer than 2^24
    return;
  }
  if (acc_int) {
    int x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = t == T_INT ? i[v] : __float2int_rz(f[v]);
    if (a == AGG_SUM) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (!MASK || ok[v]) ai = (int)((unsigned)ai + (unsigned)x[v]);
    } else if (a == AGG_MIN) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (!MASK || ok[v]) ai = min(ai, x[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (!MASK || ok[v]) ai = max(ai, x[v]);
    }
    return;
  }
  float x[V];
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = t == T_INT ? (float)i[v] : f[v];
  if (a == AGG_SUM) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!MASK || ok[v]) af += x[v];
  } else if (a == AGG_MIN) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!MASK || ok[v]) af = min_nan(af, x[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!MASK || ok[v]) af = max_nan(af, x[v]);
  }
}

// Every chain of the program on V values of one column.
template <bool MASK, int V>
__device__ __forceinline__ void run_chains(const ChainProg& prog, const float (&xf)[V],
                                           const int (&xi)[V], const bool (&ok)[V],
                                           float (&af)[MAX_CHAINS],
                                           int (&ai)[MAX_CHAINS]) {
#pragma unroll
  for (int c = 0; c < MAX_CHAINS; ++c) {
    if (c >= prog.n_chains) break;
    int t = prog.start_type[c];
    if (prog.nsteps[c] == 0) {  // the values as read: no copy to transform
      aggregate<MASK, V>(prog.agg[c], prog.acc_int[c] != 0, t, xf, xi, ok, af[c], ai[c]);
      continue;
    }
    float f[V];
    int i[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      f[v] = xf[v];
      i[v] = xi[v];
    }
    for (int s = 0; s < prog.nsteps[c]; ++s)
      t = apply_step<V>(prog.ops[c][s], prog.types[c][s], f, i);
    aggregate<MASK, V>(prog.agg[c], prog.acc_int[c] != 0, t, f, i, ok, af[c], ai[c]);
  }
}

// Thread 0: chunk k of the split (R rows from row r0) into stage k % stages.
__device__ __forceinline__ void ring_issue(const unsigned char* x, int64_t r0, int p,
                                           int elem, int sbytes, int stages, int k,
                                           uint32_t ring, uint32_t bars) {
  const int s = k % stages;
  mbar_expect_tx(bars + 8 * s, (uint32_t)sbytes);
  bulk_load(ring + (uint32_t)s * sbytes, x + r0 * p * elem, (uint32_t)sbytes,
            bars + 8 * s);
}

template <int SRC>
__global__ void __launch_bounds__(RING_THREADS, 2)
chain_ring_partials(const void* __restrict__ xv, uint32_t* __restrict__ ws, int64_t n,
                    int p, int R, int stages, int64_t rows_per_split,
                    const __grid_constant__ ChainProg prog) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ELEM = src_bytes<SRC>();
  constexpr int V = RING_V;
  const int L = RING_THREADS / p;
  const int tid = threadIdx.x, lane = tid / p, col = tid - lane * p;
  const bool active = lane < L;
  const int step = L * p;  // elements between a thread's consecutive rows
  const int sbytes = R * p * ELEM;
  const unsigned char* x = static_cast<const unsigned char*>(xv);
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = bars + RING_BARS;
  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_split;
  const int64_t r_end = min64(n, r_begin + rows_per_split);
  const int64_t rows = r_end > r_begin ? r_end - r_begin : 0;
  const int nfull = (int)(rows / R), tail = (int)(rows - (int64_t)nfull * R);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    for (int k = 0; k < min(stages, nfull); ++k)
      ring_issue(x, r_begin + (int64_t)k * R, p, ELEM, sbytes, stages, k, ring, bars);
  }
  __syncthreads();

  float af[MAX_CHAINS];
  int ai[MAX_CHAINS];
#pragma unroll
  for (int c = 0; c < MAX_CHAINS; ++c) {
    const int a = prog.agg[c];
    af[c] = a == AGG_MIN ? INFINITY : (a == AGG_MAX ? -INFINITY : 0.f);
    ai[c] = a == AGG_MIN ? INT32_MAX : (a == AGG_MAX ? INT32_MIN : 0);
  }
  bool all[V];
#pragma unroll
  for (int v = 0; v < V; ++v) all[v] = true;

  const int groups = R / (L * V);  // a full chunk: whole V-groups a thread
  for (int k = 0; k < nfull; ++k) {
    const int s = k % stages;
    mbar_wait(bars + 8 * s, (uint32_t)(k / stages) & 1u);
    const unsigned char* st = smem + RING_BARS + s * sbytes;
    if (active) {
      for (int g = 0; g < groups; ++g) {
        float xf[V];
        int xi[V];
#pragma unroll
        for (int v = 0; v < V; ++v) stage_value<SRC>(st, tid + (g * V + v) * step, xf[v], xi[v]);
        run_chains<false, V>(prog, xf, xi, all, af, ai);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && k + stages < nfull)
      ring_issue(x, r_begin + (int64_t)(k + stages) * R, p, ELEM, sbytes, stages,
                 k + stages, ring, bars);
  }
  if (tail) {  // plain loads into stage 0: every copy has landed and been read
    unsigned char* st = smem + RING_BARS;
    const unsigned char* src = x + (r_begin + (int64_t)nfull * R) * p * ELEM;
    for (int e = tid; e < tail * p; e += RING_THREADS) {
      if (ELEM == 2)
        reinterpret_cast<unsigned short*>(st)[e] = reinterpret_cast<const unsigned short*>(src)[e];
      else
        reinterpret_cast<uint32_t*>(st)[e] = reinterpret_cast<const uint32_t*>(src)[e];
    }
    __syncthreads();
    const int mine = active && lane < tail ? (tail - lane + L - 1) / L : 0;
    for (int j0 = 0; j0 < mine; j0 += V) {
      float xf[V];
      int xi[V];
      bool ok[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ok[v] = j0 + v < mine;
        xf[v] = 0.f;
        xi[v] = 0;
        if (ok[v]) stage_value<SRC>(st, tid + (j0 + v) * step, xf[v], xi[v]);
      }
      run_chains<true, V>(prog, xf, xi, ok, af, ai);
    }
  }

  // Lanes in lane order through the ring, now free: red[lane][chain][col].
  __syncthreads();
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + RING_BARS);
  if (active) {
#pragma unroll
    for (int c = 0; c < MAX_CHAINS; ++c)
      if (c < prog.n_chains)
        red[(lane * MAX_CHAINS + c) * p + col] =
            prog.acc_int[c] ? (uint32_t)ai[c] : __float_as_uint(af[c]);
  }
  __syncthreads();
  if (tid >= p) return;  // thread t < p: column t, lane 0
  for (int c = 0; c < prog.n_chains; ++c) {
    const int a = prog.agg[c];
    uint32_t out;
    if (prog.acc_int[c]) {
      int v = (int)red[c * p + tid];
      for (int l = 1; l < L; ++l) {
        const int u = (int)red[(l * MAX_CHAINS + c) * p + tid];
        if (a == AGG_MIN) v = min(v, u);
        else if (a == AGG_MAX) v = max(v, u);
        else v = (int)((unsigned)v + (unsigned)u);
      }
      out = (uint32_t)v;
    } else {
      float v = __uint_as_float(red[c * p + tid]);
      for (int l = 1; l < L; ++l) {
        const float u = __uint_as_float(red[(l * MAX_CHAINS + c) * p + tid]);
        if (a == AGG_MIN) v = nan_min(v, u);
        else if (a == AGG_MAX) v = nan_max(v, u);
        else v += u;
      }
      out = __float_as_uint(v);
    }
    ws[((int64_t)blockIdx.x * prog.n_chains + c) * p + tid] = out;
  }
}

// Shared bytes of a ring block: the barriers, then the larger of the ring
// and the lanes' partials (fused_apply_agg.py chain_plan says the same).
int64_t ring_smem(int p, int R, int stages, int elem) {
  const int64_t ring = (int64_t)stages * R * p * elem;
  const int64_t red = (int64_t)(RING_THREADS / p) * MAX_CHAINS * p * 4;
  return RING_BARS + (ring > red ? ring : red);
}

bool parse_prog(const int* prog_host, ChainProg& prog) {
  prog = ChainProg{};
  prog.n_chains = prog_host[0];
  prog.src_type = prog_host[1];
  if (prog.n_chains < 1 || prog.n_chains > MAX_CHAINS) return false;
  const int* q = prog_host + 2;
  for (int c = 0; c < prog.n_chains; ++c) {
    prog.nsteps[c] = q[0];
    prog.start_type[c] = q[1];
    prog.agg[c] = q[2];
    prog.acc_int[c] = q[3];
    for (int s = 0; s < MAX_STEPS; ++s) {
      prog.ops[c][s] = q[4 + s];
      prog.types[c][s] = q[4 + MAX_STEPS + s];
    }
    q += 4 + 2 * MAX_STEPS;
  }
  return true;
}

int combine(const void* ws, void* out, int p, int64_t splits, const ChainProg& prog,
            cudaStream_t st) {
  const int total = prog.n_chains * p;
  chain_combine<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const uint32_t*>(ws), static_cast<uint32_t*>(out), p, splits, prog);
  return (int)cudaGetLastError();
}

template <int SRC>
int launch_ring(const void* x, void* ws, void* out, int64_t n, int p, int R, int stages,
                int64_t rows_per_split, int64_t splits, const ChainProg& prog,
                cudaStream_t st) {
  constexpr int ELEM = src_bytes<SRC>();
  const int L = p >= 1 && p <= RING_THREADS ? RING_THREADS / p : 0;
  if (L == 0 || R < 1 || R % (L * RING_V) != 0 || ((int64_t)R * p * ELEM) % 16 != 0 ||
      stages < 1 || stages > RING_BARS / 8 || rows_per_split % R != 0 || splits < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = ring_smem(p, R, stages, ELEM);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  auto kern = chain_ring_partials<SRC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)splits, RING_THREADS, smem, st>>>(x, static_cast<uint32_t*>(ws), n, p,
                                                      R, stages, rows_per_split, prog);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(ws, out, p, splits, prog, st);
}

}  // namespace

extern "C" {

// prog: host ints [n_chains, src_type, then per chain: nsteps, start_type, agg,
// acc_int, ops[16], types[16]].  ws holds splits·n_chains·p words; out holds
// n_chains·p words (float32 or int32 per chain's accumulator).  The tile
// body: any p.
int fm_fused_apply_agg(const void* x, void* ws, void* out, int64_t n, int p,
                       int64_t splits, const int* prog_host, void* stream) {
  ChainProg prog;
  if (!parse_prog(prog_host, prog)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((p + TX - 1) / TX, (unsigned)splits);
  chain_partials<<<grid, dim3(TX, TY), 0, st>>>(x, static_cast<uint32_t*>(ws), n, p,
                                                rps, prog);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(ws, out, p, splits, prog, st);
}

// The ring body for p ≤ 256: x 16-byte aligned, R rows a chunk (a whole
// number of ⌊256/p⌋·RING_V rows, R·p·elem a multiple of 16), rows_per_split
// a multiple of R; ws and out as fm_fused_apply_agg.  Geometry from
// fused_apply_agg.py chain_plan.
int fm_fused_apply_agg_ring(const void* x, void* ws, void* out, int64_t n, int p, int R,
                            int stages, int64_t rows_per_split, int64_t splits,
                            const int* prog_host, void* stream) {
  ChainProg prog;
  if (!parse_prog(prog_host, prog)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (prog.src_type) {
    case T_INT:
      return launch_ring<T_INT>(x, ws, out, n, p, R, stages, rows_per_split, splits, prog, st);
    case T_F32:
      return launch_ring<T_F32>(x, ws, out, n, p, R, stages, rows_per_split, splits, prog, st);
    case T_BF16:
      return launch_ring<T_BF16>(x, ws, out, n, p, R, stages, rows_per_split, splits, prog,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
