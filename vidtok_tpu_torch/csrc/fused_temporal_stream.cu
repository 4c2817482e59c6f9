// Kernel F: one chunk step of the causal temporal residual block (layernorm)
// in a stream, with a 2-frame cache per conv.
//
// Replaces vidtok_tpu/ops/pallas/fused_temporal.py:274
// fused_temporal_resblock_stream (pallas_call at :308, body _stream_kernel
// at :72). For x [B, t, S = H*W, C] bf16 and caches c1, c2 [B, 2, S, C] bf16
// holding ACTIVATED frames:
//
//   a1    = ln_silu(x; norm1)
//   full1 = [c1 | a1]        (first chunk: activated frame 0 twice)
//   h     = conv1_t(full1) + b1        VALID k=3 in time: t output frames
//   a2    = ln_silu(h; norm2)
//   full2 = [c2 | a2]        (first chunk: a2 frame 0 twice)
//   y     = x + conv2_t(full2) + b2    residual in f32
//   new c1, c2 = full1, full2 frames [L-off-2, L-off), L = t + 2
//
// Bound on the H100: that of kernel B (fused_temporal.cu), memory at 128
// channels and math at 512. The step does 12*C FLOP per element of x and
// must move x and y and read and write 4 cache frames: 4 + 16/t bytes per
// element, so 77-320 FLOP/byte at C=128 for t = 1..20, under the ~295
// FLOP/byte bf16 ridge below t = 14, and 4x that at C=512. The scratch
// passes below add ~10 bytes per element of traffic, much of it from L2
// at the decoder's small chunks.
//
// Design: kernel B's steps over a scratch of t + 2 frames per clip. A prep
// pass writes the cache (or activated frame 0) into frames 0-1 and
// LN+SiLU of the input into frames 2.., one warp per row; conv1 is the
// shared implicit GEMM (igemm_conv.cuh) with kTemporal taps and
// Geometry::pre = 2, so every tap reads a real frame of the scratch and no
// tap needs the stream-start rule; the new c1 is copied out of the scratch
// (cudaMemcpy2DAsync, stream-ordered) before the prep pass refills it from
// h and c2; conv2 adds x in its epilogue; the new c2 is copied out last.
#include "igemm_conv.cuh"

namespace {

// act[b, f] for f < T + 2: LN+SiLU of src[b, f - 2] for f >= 2; for f < 2
// the cache row cache[b, f], or LN+SiLU of src[b, 0] when ``first``. One
// warp per row of act, 16-byte accesses, C % 8 == 0.
__global__ void stream_prep_kernel(const __nv_bfloat16* __restrict__ src,
                                   const __nv_bfloat16* __restrict__ cache,
                                   const float* __restrict__ g,
                                   const float* __restrict__ b,
                                   __nv_bfloat16* __restrict__ act, int T,
                                   int S, int C, int first, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const long long per = (long long)(T + 2) * S;
  const long long bi = row / per;
  const long long r = row - bi * per;
  const int f = (int)(r / S);
  const long long s = r - (long long)f * S;
  __nv_bfloat16* dst = act + row * C;
  if (f < 2 && !first) {
    const __nv_bfloat16* p = cache + ((bi * 2 + f) * S + s) * C;
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(dst + c) = vt::ld_u4(p + c);
    return;
  }
  const __nv_bfloat16* p = src + ((bi * T + (f < 2 ? 0 : f - 2)) * S + s) * C;
  const float2 st = vt::row_stats(p, C, lane);
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    vt::unpack8(vt::ld_u4(p + c), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = vt::ln_silu(v[i], st.x, st.y, g[c + i], b[c + i]);
    *reinterpret_cast<uint4*>(dst + c) = vt::pack8(v);
  }
}

void launch_prep(const __nv_bfloat16* src, const __nv_bfloat16* cache,
                 const float* g, const float* b, __nv_bfloat16* act, int B,
                 int T, int S, int C, int first, cudaStream_t s) {
  const int warps = 8;
  const long long rows = (long long)B * (T + 2) * S;
  const long long blocks = (rows + warps - 1) / warps;
  stream_prep_kernel<<<(unsigned)blocks, warps * 32, 0, s>>>(src, cache, g, b, act, T, S,
                                                             C, first, rows);
}

// new cache [B, 2, S, C] = act[:, T-off : T-off+2] (act clips are T + 2 long)
cudaError_t copy_cache(__nv_bfloat16* dst, const __nv_bfloat16* act, int B, int T,
                       int S, int C, int off, cudaStream_t s) {
  const size_t frame = (size_t)S * C * sizeof(__nv_bfloat16);
  return cudaMemcpy2DAsync(dst, 2 * frame, act + (size_t)(T - off) * S * C,
                           (size_t)(T + 2) * frame, 2 * frame, B,
                           cudaMemcpyDeviceToDevice, s);
}

}  // namespace

extern "C" int vt_fused_temporal_resblock_stream(
    const void* x, const void* c1, const void* c2, void* out, void* nc1,
    void* nc2, void* h1, void* act, const void* g1, const void* b1,
    const void* w1, const void* bias1, const void* g2, const void* b2,
    const void* w2, const void* bias2, int B, int T, int S, int C, int first,
    int offset, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h1);
  auto* ab = static_cast<__nv_bfloat16*>(act);
  igemm::Geometry geo{1, 1, T, S, 0};
  geo.pre = 2;

  launch_prep(xb, static_cast<const __nv_bfloat16*>(c1), static_cast<const float*>(g1),
              static_cast<const float*>(b1), ab, B, T, S, C, first, s);
  const igemm::Params p1{ab, static_cast<const __nv_bfloat16*>(w1),
                         static_cast<const float*>(bias1), nullptr, nullptr,
                         hb, M, C, C, 0};
  igemm::launch_conv<igemm::kTemporal>(p1, geo, s);
  cudaError_t e = copy_cache(static_cast<__nv_bfloat16*>(nc1), ab, B, T, S, C, offset, s);
  if (e != cudaSuccess) return (int)e;

  launch_prep(hb, static_cast<const __nv_bfloat16*>(c2), static_cast<const float*>(g2),
              static_cast<const float*>(b2), ab, B, T, S, C, first, s);
  const igemm::Params p2{ab, static_cast<const __nv_bfloat16*>(w2),
                         static_cast<const float*>(bias2), nullptr, xb,
                         static_cast<__nv_bfloat16*>(out), M, C, C, 0};
  igemm::launch_conv<igemm::kTemporal>(p2, geo, s);
  e = copy_cache(static_cast<__nv_bfloat16*>(nc2), ab, B, T, S, C, offset, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
