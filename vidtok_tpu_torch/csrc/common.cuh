// Shared device code for the vidtok_tpu_torch kernels (sm_90a).
//
// ln_silu is the port of vidtok_tpu/ops/pallas/act.py:119 ln_silu_fast, the
// LayerNorm+SiLU epilogue every JAX kernel uses by default: mean and E[x^2]
// in f32, var = max(E[x^2] - mean^2, 0), sigmoid through 0.5*tanh(0.5y)+0.5.
// The JAX form rounds each pointwise step to the tile dtype; here the
// pointwise math runs in f32 and rounds once, to the bf16 a conv consumes.
//
// Statistics depend on a position only. act_rows_kernel normalizes a
// position's channels and writes the activated row, which a conv then reads
// once per tap from L2; the decoder tail (decoder_tail.cu) takes them in
// registers while it activates its own halo boxes.
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

// The front of a temporal scratch (act_rows_kernel's stream form): the
// cache's rows as they are (kernel F after its first chunk), LN+SiLU of src
// frame 0 twice (F's first chunk, kernel B in replicate mode), or zeros
// (B in zero mode).
enum Front { kFrontCache = 0, kFrontReplicate = 1, kFrontZero = 2 };

// The rows of act_rows_kernel. Plain form: act row r = LN+SiLU of src row
// r. Stream form (the prep of kernels B and F): act holds clips of T + 2
// frames of S rows; frames 0-1 are the front (``front``), frame f >= 2 is
// LN+SiLU of src frame f - 2, and when ``copy`` is not null frames
// [T - offset, T - offset + 2) are also written to it, [B, 2, S, C], the
// new cache.
struct RowArgs {
  const __nv_bfloat16* src;
  const float* g;
  const float* b;
  __nv_bfloat16* act;
  const __nv_bfloat16* cache;  // stream form, kFrontCache
  __nv_bfloat16* copy;         // stream form: the new cache, or null
  int T, S, front, offset;     // stream form
};

// LN+SiLU rows with the whole warp busy: a row takes LPR = min(C/8, 32)
// lanes, VPL 16-byte vectors a lane, so at C = 128 a warp holds two rows;
// each thread loads its RPT rows before it reduces any, keeping RPT * VPL
// loads in flight. The statistics are ln_silu_fast's: the mean and E[x^2]
// in f32, var = max(E[x^2] - mean^2, 0).
template <int LPR, int VPL, int RPT, bool STREAM>
static __global__ void __launch_bounds__(256)
    act_rows_kernel(const RowArgs a, long long rows, int C) {
  constexpr int RPW = 32 / LPR;  // rows a warp holds at once
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 =
      ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) * (RPW * RPT) + lane / LPR;
  uint4 v[RPT][VPL];
  long long dst[RPT], cp[RPT];  // act row (-1 past the end), copy row or -1
  bool raw[RPT];                // a front row of the cache or zeros: not activated
  // stream form: clip, frame and position of the first row, then stepped
  // RPW rows at a time (the divisions once a thread)
  long long bi = 0, pos = 0;
  int f = 0;
  if (STREAM) {
    const long long per = (long long)(a.T + 2) * a.S;
    bi = row0 / per;
    const long long r = row0 - bi * per;
    f = (int)(r / a.S);
    pos = r - (long long)f * a.S;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long row = row0 + (long long)k * RPW;
    dst[k] = row < rows ? row : -1;
    cp[k] = -1;
    raw[k] = false;
    const __nv_bfloat16* p = a.src + row * C;
    bool zero = false;
    if (STREAM) {
      if (k > 0)
        for (pos += RPW; pos >= a.S; pos -= a.S)
          if (++f == a.T + 2) {
            f = 0;
            ++bi;
          }
      raw[k] = f < 2 && a.front != kFrontReplicate;
      zero = f < 2 && a.front == kFrontZero;
      p = raw[k] && !zero ? a.cache + ((bi * 2 + f) * a.S + pos) * C
                          : a.src + ((bi * a.T + (f < 2 ? 0 : f - 2)) * a.S + pos) * C;
      const int fc = f - (a.T - a.offset);
      if (a.copy != nullptr && fc >= 0 && fc < 2) cp[k] = (bi * 2 + fc) * a.S + pos;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      v[k][i] = dst[k] >= 0 && !zero ? ld_u4(p + 8 * l + 8 * LPR * i) : make_uint4(0, 0, 0, 0);
  }
  float g[VPL][8], b[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[i][e] = a.g[8 * l + 8 * LPR * i + e];
      b[i][e] = a.b[8 * l + 8 * LPR * i + e];
    }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float f[VPL][8];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      unpack8(v[k][i], f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += f[i][e];
        ss += f[i][e] * f[i][e];
      }
    }
#pragma unroll
    for (int o = LPR / 2; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / C;
    const float rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.f) + kLnEps);
    if (dst[k] < 0) continue;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = 8 * l + 8 * LPR * i;
      uint4 o = v[k][i];
      if (!raw[k]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[i][e] = ln_silu(f[i][e], mu, rs, g[i][e], b[i][e]);
        o = pack8(f[i]);
      }
      *reinterpret_cast<uint4*>(a.act + dst[k] * C + c) = o;
      if (STREAM && cp[k] >= 0) *reinterpret_cast<uint4*>(a.copy + cp[k] * C + c) = o;
    }
  }
}

// act_rows_kernel over ``rows`` rows of C channels, C in {64, 128, 256, 512,
// 768, 1024} (ops/kernels/plan.py: ROW_CHANNELS); cudaErrorInvalidValue for
// another C.
template <bool STREAM>
static inline int launch_act_rows(const RowArgs& a, long long rows, int C, cudaStream_t s) {
#define VT_ACT_ROWS(L, V, R)                                                              \
  {                                                                                       \
    const long long per = 8LL * (32 / L) * R;                                             \
    act_rows_kernel<L, V, R, STREAM><<<(unsigned)((rows + per - 1) / per), 256, 0, s>>>( \
        a, rows, C);                                                                      \
    return (int)cudaGetLastError();                                                       \
  }
  if (C % 8 == 0) switch (C / 8) {
      case 8: VT_ACT_ROWS(8, 1, 4)
      case 16: VT_ACT_ROWS(16, 1, 4)
      case 32: VT_ACT_ROWS(32, 1, 4)
      case 64: VT_ACT_ROWS(32, 2, 2)
      case 96: VT_ACT_ROWS(32, 3, 1)
      case 128: VT_ACT_ROWS(32, 4, 1)
    }
#undef VT_ACT_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace vt
