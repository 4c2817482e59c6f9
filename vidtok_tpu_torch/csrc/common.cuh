// Shared device code for the vidtok_tpu_torch kernels (sm_90a).
//
// ln_silu is the port of vidtok_tpu/ops/pallas/act.py:119 ln_silu_fast, the
// LayerNorm+SiLU epilogue every JAX kernel uses by default: mean and E[x^2]
// in f32, var = max(E[x^2] - mean^2, 0), sigmoid through 0.5*tanh(0.5y)+0.5.
// The JAX form rounds each pointwise step to the tile dtype; here the
// pointwise math runs in f32 and rounds once, to the bf16 a conv consumes.
//
// Statistics depend on a position only. ln_silu_rows_kernel normalizes a
// position's channels with one warp and writes the activated row, which a
// conv then reads once per tap from L2; ln_stats_kernel only writes the
// (mean, rstd) pair, for a consumer that activates while loading its tile.
//
// ln_silu_exact_f32 and row_stats_exact are the exact form of
// vidtok_tpu/ops/pallas/fused_temporal.py:32 _ln_silu (the mean, then the
// mean of squared deviations, y * sigmoid(y), all in f32), which the
// temporal microbenchmark's kernels compute (microbench_temporal.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// LayerNorm affine + SiLU of one value given its position's (mean, rstd).
__device__ __forceinline__ float ln_silu(float x, float mu, float rs, float g,
                                         float b) {
  float y = (x - mu) * rs * g + b;
  return y * (0.5f * tanh_fast(0.5f * y) + 0.5f);
}

// The exact form, vidtok_tpu/ops/pallas/fused_temporal.py:32 _ln_silu:
// affine, then y * sigmoid(y), all in f32; (mu, rs) from row_stats_exact.
__device__ __forceinline__ float ln_silu_exact_f32(float x, float mu, float rs,
                                                   float g, float b) {
  const float y = (x - mu) * rs * g + b;
  return y / (1.f + __expf(-y));
}

__device__ __forceinline__ uint4 ld_u4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// (mean, rsqrt(max(E[x^2]-mean^2, 0) + eps)) over the C channels of row p,
// in f32; every lane of the calling warp gets the pair. 16-byte loads,
// C % 8 == 0.
__device__ __forceinline__ float2 row_stats(const __nv_bfloat16* p, int C,
                                            int lane) {
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    unpack8(ld_u4(p + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += f[i];
      ss += f[i] * f[i];
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / C;
  return make_float2(mu, rsqrtf(fmaxf(ss / C - mu * mu, 0.f) + kLnEps));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, rsqrt(mean((x - mean)^2) + eps)) in f32, two passes, of a row that
// one warp holds in registers: lane l has v[i][e] = channel 256i + 8l + e;
// channels >= C are ignored. Every lane gets the pair.
template <int NV>
__device__ __forceinline__ float2 row_stats_exact(const float (&v)[NV][8], int C,
                                                  int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (256 * i + 8 * lane < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
  const float mu = warp_sum(s) / C;
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (256 * i + 8 * lane < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) d += (v[i][e] - mu) * (v[i][e] - mu);
  return make_float2(mu, rsqrtf(warp_sum(d) / C + kLnEps));
}

// stats[row] = row_stats(x[row]); one warp per row.
static __global__ void ln_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                       float2* __restrict__ stats,
                                       long long rows, int C) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const float2 st = row_stats(x + row * C, C, lane);
  if (lane == 0) stats[row] = st;
}

static inline void launch_ln_stats(const __nv_bfloat16* x, float2* stats,
                                   long long rows, int C, cudaStream_t s) {
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  ln_stats_kernel<<<(unsigned)blocks, warps * 32, 0, s>>>(x, stats, rows, C);
}

// act[row] = bf16(ln_silu(x[row])): the row's statistics, then the row is
// read again (from L1) and its activation written. One warp per row,
// 16-byte accesses. C % 8 == 0.
static __global__ void ln_silu_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b,
                                           __nv_bfloat16* __restrict__ act,
                                           long long rows, int C) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const __nv_bfloat16* p = x + row * C;
  const float2 st = row_stats(p, C, lane);
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    unpack8(ld_u4(p + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = ln_silu(f[i], st.x, st.y, g[c + i], b[c + i]);
    *reinterpret_cast<uint4*>(act + row * C + c) = pack8(f);
  }
}

static inline void launch_ln_silu_rows(const __nv_bfloat16* x, const float* g,
                                       const float* b, __nv_bfloat16* act,
                                       long long rows, int C, cudaStream_t s) {
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  ln_silu_rows_kernel<<<(unsigned)blocks, warps * 32, 0, s>>>(x, g, b, act, rows, C);
}

}  // namespace vt
