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
// f32 activations (the f32 scheme of wgmma_conv.cuh): the row passes read
// f32, take the statistics in two passes (row_stats_exact: the mean, then
// the mean of squared deviations), compute the affine and the SiLU in f32
// with an accurate tanh (ln_silu_f32; act.py's ln_silu_f32 is its plain
// form) and write the activated row as its three bf16 pieces (split3:
// hi + mid + lo == x) for the wgmma loop, each piece in a plane of its own
// (piece q of row r at q * rows * C + r * C); or write the statistics alone
// (mean, rstd: 8 bytes a row) for the decoder tail, which activates its own
// halo boxes from them (its f32 form, and its bf16 form past 128 channels).
//
// Any C % 8 == 0 up to 1024: a row's lanes hold whole 16-byte vectors of 8
// channels, and the vectors from channel C on are masked (VT_ROW_LAYOUTS).
//
// ln_silu_exact_f32 and row_stats_exact are the exact form of
// vidtok_tpu/ops/pallas/fused_temporal.py:32 _ln_silu (the mean, then the
// mean of squared deviations, y * sigmoid(y), all in f32), which the
// temporal microbenchmark's row passes compute (microbench_temporal.cu) in
// act_rows_kernel's layout.
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

// ln_silu in f32: the same affine and sigmoid through 0.5 tanh(0.5 y) +
// 0.5, with tanhf (within 2 ulp) in place of tanh.approx's 2^-11.
__device__ __forceinline__ float ln_silu_f32(float x, float mu, float rs, float g, float b) {
  const float y = (x - mu) * rs * g + b;
  return y * (0.5f * tanhf(0.5f * y) + 0.5f);
}

// The exact form, vidtok_tpu/ops/pallas/fused_temporal.py:32 _ln_silu:
// affine, then y * sigmoid(y) = y / (1 + exp(-y)), all in f32; (mu, rs) from
// row_stats_exact. The exp and the division are the SFU's (ex2 and rcp,
// each within 2 ulp of f32: far inside the bf16 the value is rounded to);
// an IEEE division would add about 8 instructions a value to passes the
// issue rate already bounds. For y < -87 the exp is inf and the value -0.
__device__ __forceinline__ float ln_silu_exact_f32(float x, float mu, float rs,
                                                   float g, float b) {
  const float y = (x - mu) * rs * g + b;
  return __fdividef(y, 1.f + __expf(-y));
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

// 8 channels in the element type of a tensor: bf16 (one 16-byte vector) or
// f32 (two); loaded to f32 registers and stored from them.
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* f) { unpack8(ld_u4(p), f); }
__device__ __forceinline__ void ld8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}
__device__ __forceinline__ void st8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The element type of a kernel's activations: bf16, or f32 under the f32
// scheme.
template <bool F32> struct Act { using T = __nv_bfloat16; };
template <> struct Act<true> { using T = float; };

// The f32 scheme's operands (wgmma_conv.cuh): x = hi + mid + lo, each
// piece bf16, the remainder after each piece exact in f32; pieces[q] holds
// piece q of 8 values. The remainder after lo is below 2^-24 |x|.
constexpr int kPieces = 3;
__device__ __forceinline__ void split3(const float* f, uint4 (&pieces)[kPieces]) {
  float r[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = f[e];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    pieces[k] = pack8(r);
    unpack8(pieces[k], q);
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] -= q[e];
  }
}

// The pieces of 8 channels into a split scratch of piece planes ``plane``
// elements apart: piece q at split + q * plane + off.
__device__ __forceinline__ void st_split8(__nv_bfloat16* split, long long plane, long long off,
                                          const float* f) {
  uint4 pieces[kPieces];
  split3(f, pieces);
#pragma unroll
  for (int k = 0; k < kPieces; ++k)
    *reinterpret_cast<uint4*>(split + k * plane + off) = pieces[k];
}

// Whether vector i of lane l of a row (channels 8l + 8 LPR i .. + 7) lies
// below C; a masked vector is loaded as zeros and never stored.
template <int LPR>
__device__ __forceinline__ bool row_vec(int l, int i, int C) {
  return 8 * l + 8 * LPR * i < C;
}

// (mean, rsqrt(mean((x - mean)^2) + eps)) in f32, two passes, of a row of
// C channels held by LPR neighbouring lanes (the row passes' layout: lane l
// of the row has v[i][e] = channel 8l + 8 LPR i + e, zeros from channel C
// on, which the deviations leave out), each sum reduced over those lanes by
// xor shuffles; every lane of the row gets the pair. The whole warp must
// call it.
template <int LPR, int VPL>
__device__ __forceinline__ float2 row_stats_exact(const float (&v)[VPL][8], int C, int l) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[i][e];
#pragma unroll
  for (int o = LPR / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / C;
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (row_vec<LPR>(l, i, C))
#pragma unroll
      for (int e = 0; e < 8; ++e) d += (v[i][e] - mu) * (v[i][e] - mu);
#pragma unroll
  for (int o = LPR / 2; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  return make_float2(mu, rsqrtf(d / C + kLnEps));
}

// The row passes' layout of C channels (ops/kernels/plan.py: row_layout):
// CASE(LPR, VPL, RPT) for C % 8 == 0, 8 <= C <= 1024, nothing for another
// C. A row takes LPR lanes, the power of two from 8 to 32 that holds C / 8
// vectors (so the xor shuffles reduce within the row), VPL 16-byte vectors
// of 8 channels a lane, the vectors from channel C on masked, and a thread
// RPT rows, loaded before any is reduced.
#define VT_ROW_LAYOUTS(C, CASE)                   \
  if ((C) % 8 == 0 && (C) >= 8 && (C) <= 1024) {  \
    if ((C) <= 64) CASE(8, 1, 4)                  \
    else if ((C) <= 128) CASE(16, 1, 4)           \
    else if ((C) <= 256) CASE(32, 1, 4)           \
    else if ((C) <= 512) CASE(32, 2, 2)           \
    else if ((C) <= 768) CASE(32, 3, 1)           \
    else CASE(32, 4, 1)                           \
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
//
// The row form (RowForm) sets the element types: kRowBf16 reads bf16 and
// writes the bf16 activation; kRowSplit reads f32 (src, cache) and writes
// the activation's three bf16 pieces, act [3][rows][C] (st_split8), the new
// cache in f32, and, when ``raw`` is not null, the pieces of src itself,
// raw [3][rows][C] (plain form: kernel A's 1x1 shortcut); kRowStats reads
// f32 and kRowStatsBf16 bf16, and both write each row's two-pass (mean,
// rstd) as a float2, act [rows] (plain form: the decoder tail's; g and b
// are read but not applied).
enum RowForm { kRowBf16 = 0, kRowSplit = 1, kRowStats = 2, kRowStatsBf16 = 3 };

struct RowArgs {
  const void* src;    // bf16 (kRowBf16, kRowStatsBf16), else f32
  const float* g;
  const float* b;
  void* act;
  const void* cache;  // stream form, kFrontCache: activated rows, src's type
  void* copy;         // stream form: the new cache (src's type), or null
  int T, S, front, offset;  // stream form
  void* raw;          // kRowSplit, plain form: src's pieces, or null
};

// 8 channels as a row pass holds them between its loads and its math:
// the 16-byte bf16 vector, or f32 values.
template <typename T> struct Held { uint4 u; };
template <> struct Held<float> { float f[8]; };

__device__ __forceinline__ void hold(Held<__nv_bfloat16>& h, const __nv_bfloat16* p, bool load) {
  h.u = load ? ld_u4(p) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void hold(Held<float>& h, const float* p, bool load) {
  if (load) {
    ld8(p, h.f);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) h.f[e] = 0.f;
  }
}
__device__ __forceinline__ void unhold(const Held<__nv_bfloat16>& h, float* f) { unpack8(h.u, f); }
__device__ __forceinline__ void unhold(const Held<float>& h, float* f) {
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = h.f[e];
}

// LN+SiLU rows with the whole warp busy: a row takes LPR = min(C/8, 32)
// lanes, VPL 16-byte vectors a lane, so at C = 128 a warp holds two rows;
// each thread loads its RPT rows before it reduces any, keeping RPT * VPL
// loads in flight. The statistics of bf16 rows are ln_silu_fast's: the
// mean and E[x^2] in f32, var = max(E[x^2] - mean^2, 0); those of f32 rows
// are row_stats_exact's two passes, which keep f32's digits where a row's
// mean is large beside its spread.
template <int LPR, int VPL, int RPT, bool STREAM, int FORM = kRowBf16>
static __global__ void __launch_bounds__(256)
    act_rows_kernel(const RowArgs a, long long rows, int C) {
  using In = typename Act<FORM == kRowSplit || FORM == kRowStats>::T;
  constexpr bool STATS = FORM == kRowStats || FORM == kRowStatsBf16;
  constexpr int RPW = 32 / LPR;  // rows a warp holds at once
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 =
      ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) * (RPW * RPT) + lane / LPR;
  const In* src = static_cast<const In*>(a.src);
  const In* cache = static_cast<const In*>(a.cache);
  Held<In> v[RPT][VPL];
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
    const In* p = src + row * C;
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
      p = raw[k] && !zero ? cache + ((bi * 2 + f) * a.S + pos) * C
                          : src + ((bi * a.T + (f < 2 ? 0 : f - 2)) * a.S + pos) * C;
      const int fc = f - (a.T - a.offset);
      if (a.copy != nullptr && fc >= 0 && fc < 2) cp[k] = (bi * 2 + fc) * a.S + pos;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      hold(v[k][i], p + 8 * l + 8 * LPR * i, dst[k] >= 0 && !zero && row_vec<LPR>(l, i, C));
  }
  float g[VPL][8], b[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const bool ok = row_vec<LPR>(l, i, C);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[i][e] = ok ? a.g[8 * l + 8 * LPR * i + e] : 0.f;
      b[i][e] = ok ? a.b[8 * l + 8 * LPR * i + e] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float f[VPL][8];
#pragma unroll
    for (int i = 0; i < VPL; ++i) unhold(v[k][i], f[i]);
    float mu, rs;
    if constexpr (FORM == kRowBf16) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += f[i][e];
          ss += f[i][e] * f[i][e];
        }
#pragma unroll
      for (int o = LPR / 2; o; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      mu = s / C;
      rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.f) + kLnEps);
    } else {
      const float2 st = row_stats_exact<LPR, VPL>(f, C, l);
      mu = st.x;
      rs = st.y;
    }
    if (dst[k] < 0) continue;
    if constexpr (STATS) {
      if (l == 0) static_cast<float2*>(a.act)[dst[k]] = make_float2(mu, rs);
      continue;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = 8 * l + 8 * LPR * i;
      if (!row_vec<LPR>(l, i, C)) continue;
      if constexpr (FORM == kRowBf16) {
        uint4 o = v[k][i].u;
        if (!raw[k]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[i][e] = ln_silu(f[i][e], mu, rs, g[i][e], b[i][e]);
          o = pack8(f[i]);
        }
        auto* act = static_cast<__nv_bfloat16*>(a.act);
        *reinterpret_cast<uint4*>(act + dst[k] * C + c) = o;
        if (STREAM && cp[k] >= 0)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.copy) + cp[k] * C + c) = o;
      } else {
        const long long plane = rows * C, off = dst[k] * C + c;
        if (FORM == kRowSplit && !STREAM && a.raw != nullptr)
          st_split8(static_cast<__nv_bfloat16*>(a.raw), plane, off, f[i]);
        if (!raw[k]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[i][e] = ln_silu_f32(f[i][e], mu, rs, g[i][e], b[i][e]);
        }
        st_split8(static_cast<__nv_bfloat16*>(a.act), plane, off, f[i]);
        if (STREAM && cp[k] >= 0) st8(static_cast<float*>(a.copy) + cp[k] * C + c, f[i]);
      }
    }
  }
}

// act_rows_kernel over ``rows`` rows of C channels in VT_ROW_LAYOUTS's
// layout; cudaErrorInvalidValue for another C.
template <bool STREAM, int FORM = kRowBf16>
static inline int launch_act_rows(const RowArgs& a, long long rows, int C, cudaStream_t s) {
#define VT_ACT_ROWS(L, V, R)                                                    \
  {                                                                             \
    const long long per = 8LL * (32 / L) * R;                                   \
    act_rows_kernel<L, V, R, STREAM, FORM>                                      \
        <<<(unsigned)((rows + per - 1) / per), 256, 0, s>>>(a, rows, C);        \
    return (int)cudaGetLastError();                                             \
  }
  VT_ROW_LAYOUTS(C, VT_ACT_ROWS)
#undef VT_ACT_ROWS
  return (int)cudaErrorInvalidValue;
}

// The f32 scheme's split of rows that are not activated (kernel E's input
// s): src [rows, C] f32 -> dst [3][rows][C], piece q in plane q. One thread
// per 8 channels.
static __global__ void __launch_bounds__(256)
    split_rows_kernel(const float* src, __nv_bfloat16* dst, long long rows, int C) {
  const int cv = C / 8;
  const long long total = rows * cv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / cv;
    const int c = (int)(i - row * cv) * 8;
    float f[8];
    ld8(src + row * C + c, f);
    st_split8(dst, rows * C, row * C + c, f);
  }
}

static inline int launch_split_rows(const float* src, __nv_bfloat16* dst, long long rows,
                                    int C, cudaStream_t s) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  const long long want = (rows * (C / 8) + 255) / 256;
  const unsigned grid = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  split_rows_kernel<<<grid > 0 ? grid : 1, 256, 0, s>>>(src, dst, rows, C);
  return (int)cudaGetLastError();
}

}  // namespace vt
