// Fused apply→aggregate: N chains of unary VUDFs, each followed by a column
// aggregation, from ONE read of a tall row-major X (n, p).
//
// Replaces the Pallas kernel repro/kernels/fused_apply_agg.py:_chain_kernel.
// The chain spec arrives as a small int program built on the host
// (repro_torch/kernels/fused_apply_agg.py): per chain its steps' opcodes and
// the value type at each step (int32, f32, or bf16 — the JAX chain changes
// type at sqrt, cast_*, ...), its aggregation and its accumulator type.  The
// program travels by value as a kernel parameter, so every thread reads it
// from the constant bank and the branches on it are uniform.
//
//   launch 1 (chain_partials): grid (column tiles of 32, row splits), block
//     32×8.  Neighbouring threads take neighbouring columns of one row, so a
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
// jnp.minimum/jnp.maximum (fminf/fmaxf do not).  Bound: the one read of X;
// the chain interpretation costs instructions per element, which is what
// this first version spends instead of specialising per chain spec.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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

}  // namespace

extern "C" {

// prog: host ints [n_chains, src_type, then per chain: nsteps, start_type, agg,
// acc_int, ops[16], types[16]].  ws holds splits·n_chains·p words; out holds
// n_chains·p words (float32 or int32 per chain's accumulator).
int fm_fused_apply_agg(const void* x, void* ws, void* out, int64_t n, int p,
                       int64_t splits, const int* prog_host, void* stream) {
  ChainProg prog = {};
  prog.n_chains = prog_host[0];
  prog.src_type = prog_host[1];
  if (prog.n_chains < 1 || prog.n_chains > MAX_CHAINS) return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rps = (n + splits - 1) / splits;
  dim3 grid((p + TX - 1) / TX, (unsigned)splits);
  chain_partials<<<grid, dim3(TX, TY), 0, st>>>(x, static_cast<uint32_t*>(ws), n, p,
                                                rps, prog);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = prog.n_chains * p;
  chain_combine<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const uint32_t*>(ws), static_cast<uint32_t*>(out), p, splits, prog);
  return (int)cudaGetLastError();
}

}  // extern "C"
