// Kernels J and K: the v1.1 trilinear temporal upsample's two memory-bound
// passes around cuDNN's 3x3x3 conv (modules/blocks.py TimeUpsampleRes2x).
//
// They replace no TPU kernel: the JAX module runs this chain as XLA's
// elementwise ops (vidtok_tpu/modules/interp.py temporal_linear_up2x, the
// head/tail split and the blend of blocks.py:538-571). The port ran it as
// PyTorch's: an f32 copy of x, two cats, six scalar passes, a stack and a
// cast of the doubled frames, a cat for the conv's front, the conv's bias
// add and three passes of the blend.
//
// J, temporal_linear_kernel: x [B, T, S, C] (S = H * W) -> full [B, 2 + 2T,
// S, C], the conv's input with its 2-frame time front already in place:
//
//   out[2 + 2j]     = 0.25 * prev_j + 0.75 * x[j]
//   out[2 + 2j + 1] = 0.75 * x[j]   + 0.25 * next_j
//
// prev_j = x[j-1], next_j = x[j+1], except at the ends of the two segments
// [0, split) and [split, T), where the frame itself stands in; frame 0's
// prev is the last frame of `prev` (a later stream chunk's cached input
// frames) when given. The front: zeros, up-frame 0 twice (replicate), or
// the 2 cached up-frames. Arithmetic in f32 in interp.py's order, products
// and sums rounded apart (no FMA contraction), rounded once to x's type:
// bit-equal to the plain chain in bf16 and in f32.
//
// K, linear_blend_kernel: y [B, 2T, S, C], the conv's output without its
// bias, becomes
//
//   y = alpha * up + (1 - alpha) * (y + bias),   up = full[:, 2:]
//
// in place, in f32, rounded once (bit-equal to PyTorch's bias add and blend
// in f32; one rounding in place of four in bf16). alpha is one f32 on the
// device, read by every thread: no host synchronisation.
//
// Bound on the H100: memory only, 4 (J) and 5 (K) FLOP an output value.
// J reads x once and writes each output frame once (the front's cache
// frames read once); K reads up and y once and writes y once.
// Design: J gives one thread to each 16-byte channel vector of one (b, s)
// and walks T with prev, cur and next in registers, so neighbouring
// threads touch neighbouring addresses in every frame; K one thread to each
// 16-byte vector of y. Any C: vectors of 8 (bf16) or 4 (f32) channels when
// C and every pointer allow, else one channel a thread. Offsets are 64-bit.
#include "common.cuh"

namespace {

enum TemporalFront { kFrontZero = 0, kFrontReplicate = 1, kFrontCached = 2 };

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

// The loads of x run two frames ahead of the frame being written (raw
// registers ahead1, ahead2), so each thread keeps two loads in flight.
template <typename T, int V>
__global__ void temporal_linear_kernel(const T* __restrict__ x, const T* __restrict__ prev,
                                       int n_prev, const T* __restrict__ cache,
                                       T* __restrict__ out, int T_, int S, int C, int split,
                                       int front, long long total) {
  using Raw = typename Vec<T, V>::Raw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cv = C / V;
  const int c = (int)(i % cv) * V;
  const long long pos = i / cv;  // b * S + s
  const long long b = pos / S;
  const long long frame = (long long)S * C;
  const long long at = (pos % S) * C + c;  // (s, c) within a frame
  const T* xb = x + b * T_ * frame + at;
  T* ob = out + b * (2LL * T_ + 2) * frame + at;
  float p[V], cur[V], nxt[V], even[V], odd[V];
  Raw ahead1{}, ahead2{};
  ld<T, V>(xb, cur);
  if (T_ > 1) ahead1 = Vec<T, V>::load(xb + frame);
  if (prev != nullptr) {
    ld<T, V>(prev + (b * n_prev + n_prev - 1) * frame + at, p);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = cur[e];
  }
  if (front == kFrontCached) {
    float f[V];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ld<T, V>(cache + (b * 2 + k) * frame + at, f);
      Vec<T, V>::st(ob + k * frame, f);
    }
  }
  for (int t = 0; t < T_; ++t) {
    if (t + 2 < T_) ahead2 = Vec<T, V>::load(xb + (t + 2) * frame);
    const bool more = t + 1 < T_;
    float raw[V];
    Vec<T, V>::unpack(ahead1, raw);  // x[t + 1] when there is one
    const bool joined = more && t + 1 != split;  // x[t + 1] is in x[t]'s segment
#pragma unroll
    for (int e = 0; e < V; ++e) {
      nxt[e] = joined ? raw[e] : cur[e];
      even[e] = __fadd_rn(__fmul_rn(0.25f, p[e]), __fmul_rn(0.75f, cur[e]));
      odd[e] = __fadd_rn(__fmul_rn(0.75f, cur[e]), __fmul_rn(0.25f, nxt[e]));
    }
    Vec<T, V>::st(ob + (2 + 2LL * t) * frame, even);
    Vec<T, V>::st(ob + (3 + 2LL * t) * frame, odd);
    if (t == 0 && front != kFrontCached) {
      if (front == kFrontZero) {
#pragma unroll
        for (int e = 0; e < V; ++e) even[e] = 0.f;
      }
      Vec<T, V>::st(ob, even);
      Vec<T, V>::st(ob + frame, even);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p[e] = joined ? cur[e] : raw[e];
      cur[e] = raw[e];
    }
    ahead1 = ahead2;
  }
}

template <typename T, int V>
__global__ void linear_blend_kernel(const T* __restrict__ full, T* __restrict__ y,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ alpha, int C,
                                    long long per_clip, long long front, long long total) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= total) return;
  const int c = (int)(i % C);
  const long long up = i + (i / per_clip + 1) * front;  // full[:, 2:] at y's index
  const float a = alpha[0];
  const float na = __fsub_rn(1.f, a);
  float u[V], v[V];
  ld<T, V>(full + up, u);
  ld<T, V>(y + i, v);
#pragma unroll
  for (int e = 0; e < V; ++e)
    v[e] = __fadd_rn(__fmul_rn(a, u[e]), __fmul_rn(na, __fadd_rn(v[e], bias[c + e])));
  Vec<T, V>::st(y + i, v);
}

constexpr int kThreads = 256;

int blocks_for(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <typename T, int V>
int launch_up(const void* x, const void* prev, int n_prev, const void* cache, void* out,
              int B, int T_, int S, int C, int split, int front, void* stream) {
  const long long total = (long long)B * S * (C / V);
  temporal_linear_kernel<T, V><<<blocks_for(total), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev), n_prev,
      static_cast<const T*>(cache), static_cast<T*>(out), T_, S, C, split, front, total);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_blend(const void* full, void* y, const void* bias, const void* alpha, int B,
                 int Ty, int S, int C, void* stream) {
  const long long frame = (long long)S * C;
  const long long total = (long long)B * Ty * frame;
  linear_blend_kernel<T, V><<<blocks_for(total / V), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(full), static_cast<T*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), C, Ty * frame, 2 * frame, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x, prev (or null), n_prev, cache (or null), out, B, T, S, C, split, front
// (TemporalFront), vec (16-byte vectors when 1), stream
extern "C" int vt_temporal_linear_up2x(const void* x, const void* prev, int n_prev,
                                       const void* cache, void* out, int B, int T, int S,
                                       int C, int split, int front, int vec, void* stream) {
  return vec ? launch_up<__nv_bfloat16, 8>(x, prev, n_prev, cache, out, B, T, S, C, split,
                                           front, stream)
             : launch_up<__nv_bfloat16, 1>(x, prev, n_prev, cache, out, B, T, S, C, split,
                                           front, stream);
}

extern "C" int vt_temporal_linear_up2x_f32(const void* x, const void* prev, int n_prev,
                                           const void* cache, void* out, int B, int T, int S,
                                           int C, int split, int front, int vec,
                                           void* stream) {
  return vec ? launch_up<float, 4>(x, prev, n_prev, cache, out, B, T, S, C, split, front,
                                   stream)
             : launch_up<float, 1>(x, prev, n_prev, cache, out, B, T, S, C, split, front,
                                   stream);
}

// full, y (written in place), bias (f32), alpha (one f32), B, Ty (y's frames),
// S, C, vec, stream
extern "C" int vt_linear_blend(const void* full, void* y, const void* bias, const void* alpha,
                               int B, int Ty, int S, int C, int vec, void* stream) {
  return vec ? launch_blend<__nv_bfloat16, 8>(full, y, bias, alpha, B, Ty, S, C, stream)
             : launch_blend<__nv_bfloat16, 1>(full, y, bias, alpha, B, Ty, S, C, stream);
}

extern "C" int vt_linear_blend_f32(const void* full, void* y, const void* bias,
                                   const void* alpha, int B, int Ty, int S, int C, int vec,
                                   void* stream) {
  return vec ? launch_blend<float, 4>(full, y, bias, alpha, B, Ty, S, C, stream)
             : launch_blend<float, 1>(full, y, bias, alpha, B, Ty, S, C, stream);
}
