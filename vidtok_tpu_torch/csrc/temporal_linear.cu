// The v1.1 trilinear temporal upsample's blend (modules/blocks.py
// TimeUpsampleRes2x), on the base convs of its input frames.
//
// It replaces no TPU kernel: the JAX module runs the upsample as XLA's
// elementwise chain around a 3x3x3 conv of the doubled frames
// (vidtok_tpu/modules/interp.py temporal_linear_up2x, the head/tail split
// and the blend of blocks.py:538-571). The output frame n is
//
//   y[n] = alpha * up[n] + (1 - alpha) * (sum_k W_k * full[n + k] + bias),
//
// full = [front (2) | up (2T)], each up frame a blend of two input frames,
// up[m] = a_m x[p_m] + b_m x[q_m] (the index rule below). A spatial conv
// commutes with that blend, so the causal conv of the doubled frames is a
// blend of the three per-tap 3x3 convs P_k = W_k * x of each INPUT frame:
// cuDNN computes P [B, T, S, 3C] (taps side by side on the channels, no
// bias) over the input frames, half the FLOP of the conv on the doubled
// frames, and this kernel computes y from P and x in one pass.
//
// Index rule (the interpolation's): up[2t] = 0.25 prev(t) + 0.75 x[t], up[2t+1] =
// 0.75 x[t] + 0.25 next(t); prev(t) = x[t-1] and next(t) = x[t+1] within
// the segments [0, split) and [split, T), the frame itself at a segment's
// edge; frame 0's prev is `prev` (a later stream chunk's predecessor frame)
// when given. The front: zero, up-frame 0 twice (replicate), or carried: a
// later chunk's front sums R [B, 3, S, C], what frames before the chunk add
// to the conv of y[0], y[1], y[2] (W_0 f0 + W_1 f1 + 0.25 W_2 xp, W_0 f1 +
// 0.25 W_1 xp, 0.25 W_0 xp; f0, f1 the cached front frames, xp `prev`).
// A stream chunk also writes the next chunk's R from the frames it reads:
// rows nf and nf + 1 of full as the next front, frame q as the next
// predecessor.
//
// Design: one thread per 16-byte channel vector (bf16 x 8, f32 x 4; one
// channel when C or a pointer does not allow) of one (b, s), walking the
// frames in order, so each P frame and x frame is read from HBM once, the
// loads of frame j + 1 issued before frame j is blended. Frame j's taps are
// scattered into a window of six conv sums (y[2j-1] .. y[2j+4]), of which
// y[2j-1] and y[2j] are then complete and written. The up term is computed
// as the plain interpolation computes it (products and sums rounded apart,
// no FMA contraction); the sums and the blend in f32, rounded once.
// Bound on the H100: memory only. A chunk moves P (1.5 C an output frame),
// x (0.5 C) and y (1 C); the doubled frames are never written. Offsets are
// 64-bit.
#include "common.cuh"

namespace {

enum TemporalFront { kFrontZero = 0, kFrontReplicate = 1, kFrontCarried = 2 };

// V channels of element type T: loaded as one raw register value (a 16-byte
// vector of bf16 x 8 or f32 x 4, or one scalar when V = 1), unpacked to f32
// registers, and stored from them rounded once.
template <typename T, int V> struct Vec;
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return vt::ld_u4(p); }
  static __device__ __forceinline__ void unpack(Raw r, float* f) { vt::unpack8(r, f); }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = vt::pack8(f);
  }
};
template <> struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void st(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float* f) { f[0] = __bfloat162float(r); }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, const float* f) {
    *p = __float2bfloat16_rn(f[0]);
  }
};
template <> struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float* f) { f[0] = r; }
  static __device__ __forceinline__ void st(float* p, const float* f) { *p = f[0]; }
};

template <typename T, int V>
__device__ __forceinline__ void ld(const T* p, float* f) {
  Vec<T, V>::unpack(Vec<T, V>::load(p), f);
}

struct Rule {
  int T, split, front;
  bool prev;
};

// The coefficient of x[j] in frame m of full = [front (2) | up (2T)];
// ops/kernels/temporal_linear.py up_rows is its plain form.
__device__ __forceinline__ float up_coef(const Rule& r, int m, int j) {
  if (m < 2) {
    if (r.front != kFrontReplicate) return 0.f;
    m = 2;  // up-frame 0 twice
  }
  const int u = m - 2, t = u >> 1;
  float c = j == t ? 0.75f : 0.f;
  if (u & 1) {
    const bool edge = t == r.T - 1 || t + 1 == r.split;
    if (j == (edge ? t : t + 1)) c += 0.25f;
  } else {
    const bool edge = t == 0 ? !r.prev : t == r.split;
    if (j == (edge ? t : t - 1)) c += 0.25f;
  }
  return c;
}

// kNext: the launch writes the next chunk's front sums (a stream chunk),
// which takes more registers a thread.
template <typename T, int V, bool kNext>
__global__ void linear_blend_kernel(const T* __restrict__ x, const T* __restrict__ p,
                                    const T* __restrict__ prev, const T* __restrict__ front,
                                    T* __restrict__ out, T* __restrict__ next,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ alpha, Rule rule, int S, int C,
                                    int nf, int q, long long total) {
  using Raw = typename Vec<T, V>::Raw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cv = C / V;
  const int c = (int)(i % cv) * V;
  const long long pos = i / cv;  // b * S + s
  const long long b = pos / S;
  const long long frame = (long long)S * C, pframe = 3 * frame;
  const int T_ = rule.T;
  const T* xb = x + b * T_ * frame + (pos % S) * C + c;
  const T* pb = p + b * T_ * pframe + (pos % S) * 3 * C + c;
  T* ob = out + b * 2LL * T_ * frame + (pos % S) * C + c;
  const float a = alpha[0];
  const float na = __fsub_rn(1.f, a);
  float bs[V];
#pragma unroll
  for (int e = 0; e < V; ++e) bs[e] = bias[c + e];

  // acc[r]: the conv sum of y[2j - 1 + r] from the frames read so far;
  // nx: the next chunk's front sums
  float acc[6][V], nx[3][V];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  if (kNext) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) nx[r][e] = 0.f;
  }
  if (rule.front == kFrontCarried) {
    const T* fb = front + b * 3 * frame + (pos % S) * C + c;
    float f[3][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) ld<T, V>(fb + k * frame, f[k]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k + 1][e] = f[k][e];
    // what the next chunk's front takes of these sums (rows nf, nf + 1
    // that are this chunk's front frames or up-frame 0, whose prev share
    // they hold)
    if (kNext && nf <= 2) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        nx[0][e] = nf == 0 ? f[0][e] : nf == 1 ? f[1][e] : f[2][e];
        nx[1][e] = nf == 0 ? f[1][e] : nf == 1 ? f[2][e] : 0.f;
        nx[2][e] = nf == 0 ? f[2][e] : 0.f;
      }
    }
  }
  // x[j - 1] and x[j]; before frame 0, its predecessor
  float xm[V], xc[V];
  ld<T, V>(rule.prev ? prev + b * frame + (pos % S) * C + c : xb, xm);
  // the loads of frame j + 1 are issued before frame j is blended
  Raw rp[3], rx;
#pragma unroll
  for (int k = 0; k < 3; ++k) rp[k] = Vec<T, V>::load(pb + k * C);
  rx = Vec<T, V>::load(xb);
  for (int j = 0; j < T_; ++j) {
    Raw np[3]{}, npx{};
    if (j + 1 < T_) {
#pragma unroll
      for (int k = 0; k < 3; ++k) np[k] = Vec<T, V>::load(pb + (j + 1) * pframe + k * C);
      npx = Vec<T, V>::load(xb + (j + 1) * frame);
    }
    float pk[3][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) Vec<T, V>::unpack(rp[k], pk[k]);
    Vec<T, V>::unpack(rx, xc);
    // frame j's share of full rows 2j+1 .. 2j+4 (up[2j-1] .. up[2j+2]; at
    // j = 0 row 1 is the front's second frame), each row i adding W_k * row
    // to the conv of y[i - k]
    float cu[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cu[u] = up_coef(rule, 2 * j + 1 + u, j);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u + 2 - k][e] += cu[u] * pk[k][e];
    if (j == 0 && rule.front == kFrontReplicate) {  // row 0 (up-frame 0), W_0 into y[0]
      const float c0 = up_coef(rule, 0, 0);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[1][e] += c0 * pk[0][e];
    }
    if (kNext) {
      const float c0 = up_coef(rule, nf, j), c1 = up_coef(rule, nf + 1, j);
      const float cq = j == q ? 0.25f : 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        nx[0][e] += c0 * pk[0][e] + c1 * pk[1][e] + cq * pk[2][e];
        nx[1][e] += c1 * pk[0][e] + cq * pk[1][e];
        nx[2][e] += cq * pk[0][e];
      }
    }
    // y[2j - 1] (up[2j-1] = 0.75 x[j-1] + 0.25 next(j-1)) and y[2j]
    // (up[2j] = 0.25 prev(j) + 0.75 x[j])
    const bool joined = j != rule.split;
    const bool self = j == 0 ? !rule.prev : !joined;
    float y[V];
    if (j > 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float up = __fadd_rn(__fmul_rn(0.75f, xm[e]),
                                   __fmul_rn(0.25f, joined ? xc[e] : xm[e]));
        y[e] = __fadd_rn(__fmul_rn(a, up), __fmul_rn(na, __fadd_rn(acc[0][e], bs[e])));
      }
      Vec<T, V>::st(ob + (2LL * j - 1) * frame, y);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float up = __fadd_rn(__fmul_rn(0.25f, self ? xc[e] : xm[e]),
                                 __fmul_rn(0.75f, xc[e]));
      y[e] = __fadd_rn(__fmul_rn(a, up), __fmul_rn(na, __fadd_rn(acc[1][e], bs[e])));
    }
    Vec<T, V>::st(ob + 2LL * j * frame, y);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = acc[r + 2][e];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc[4][e] = acc[5][e] = 0.f;
      xm[e] = xc[e];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) rp[k] = np[k];
    rx = npx;
  }
  // y[2T - 1]: up[2T-1] = 0.75 x[T-1] + 0.25 x[T-1]
  float y[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float up = __fadd_rn(__fmul_rn(0.75f, xm[e]), __fmul_rn(0.25f, xm[e]));
    y[e] = __fadd_rn(__fmul_rn(a, up), __fmul_rn(na, __fadd_rn(acc[0][e], bs[e])));
  }
  Vec<T, V>::st(ob + (2LL * T_ - 1) * frame, y);
  if (kNext) {
    T* nb = next + b * 3 * frame + (pos % S) * C + c;
#pragma unroll
    for (int r = 0; r < 3; ++r) Vec<T, V>::st(nb + r * frame, nx[r]);
  }
}

constexpr int kThreads = 128;  // a thread holds 130-200 registers: finer blocks fill the SMs

template <typename T, int V>
int launch(const void* x, const void* p, const void* prev, const void* front, void* out,
           void* next, const void* bias, const void* alpha, int B, int T_, int S, int C,
           int split, int front_mode, int nf, int q, void* stream) {
  const long long total = (long long)B * S * (C / V);
  const Rule rule{T_, split, front_mode, prev != nullptr};
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  auto kernel = next != nullptr ? linear_blend_kernel<T, V, true>
                                : linear_blend_kernel<T, V, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(p), static_cast<const T*>(prev),
      static_cast<const T*>(front), static_cast<T*>(out), static_cast<T*>(next),
      static_cast<const float*>(bias), static_cast<const float*>(alpha), rule, S, C, nf, q,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

// x, p (its base convs), prev (or null), front sums (or null), out, next
// front sums (or null), bias (f32), alpha (one f32), B, T, S, C, split, front
// (TemporalFront), nf, q (the next front's rows and predecessor), vec
// (16-byte vectors when 1), stream
extern "C" int vt_temporal_linear_blend(const void* x, const void* p, const void* prev,
                                        const void* front, void* out, void* next,
                                        const void* bias, const void* alpha, int B, int T,
                                        int S, int C, int split, int front_mode, int nf,
                                        int q, int vec, void* stream) {
  return vec ? launch<__nv_bfloat16, 8>(x, p, prev, front, out, next, bias, alpha, B, T, S, C,
                                        split, front_mode, nf, q, stream)
             : launch<__nv_bfloat16, 1>(x, p, prev, front, out, next, bias, alpha, B, T, S, C,
                                        split, front_mode, nf, q, stream);
}

extern "C" int vt_temporal_linear_blend_f32(const void* x, const void* p, const void* prev,
                                            const void* front, void* out, void* next,
                                            const void* bias, const void* alpha, int B, int T,
                                            int S, int C, int split, int front_mode, int nf,
                                            int q, int vec, void* stream) {
  return vec ? launch<float, 4>(x, p, prev, front, out, next, bias, alpha, B, T, S, C, split,
                                front_mode, nf, q, stream)
             : launch<float, 1>(x, p, prev, front, out, next, bias, alpha, B, T, S, C, split,
                                front_mode, nf, q, stream);
}
