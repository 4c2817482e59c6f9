// Kernels G and H: the parity-upsample tail from the parity conv outputs.
//
// Replaces vidtok_tpu/ops/pallas/upsample_epilogue.py:49
// parity_blend_interleave (G, pallas_call at :72) and :96
// parity_blend_interleave4 (H, pallas_call at :120), whose shared body
// _kernel (:34) computes, with y_cur and y_prev phase-packed [.., 2C]
// (even | odd output frame) and s the half-rate input [B, T, H, W, C]:
//
//   y         = y_cur[t] + y_prev[t-1] + [bias | bias]        (f32)
//   out[2t+p] = bf16(alpha * s[t] + (1 - alpha) * y[pC : (p+1)C])
//
// y_prev[-1] is zeros (zero) or y_prev[0] (replicate: the TPU index map
// clamps t-1 to 0). G reads two [B, T, H, W, 2C] tensors; H one
// [B, T, H, W, 4C] tensor [cur 2C | prev 2C] from one C -> 4C conv, which
// the wrapper passes as two sources: the base and the base + 2C, each with
// a row stride of 4C.
//
// Bound on the H100: memory only; per half-rate position it reads C + 4C
// and writes 2C bf16, with 5 FLOP per output value.
// Design: one thread per 8 channels (16 bytes) of a half-rate position, in
// input order: it reads s once and its two y_cur and two y_prev vectors,
// and writes both output frames, so every load and store is a coalesced
// 16-byte vector. Offsets are 64-bit: a [1, 10, 256, 256, 256] call writes
// 3.4e8 elements.
#include "common.cuh"

namespace {

__global__ void parity_blend_kernel(const __nv_bfloat16* __restrict__ s,
                                    const __nv_bfloat16* __restrict__ ycur,
                                    const __nv_bfloat16* __restrict__ yprev,
                                    int ld, const float* __restrict__ bias,
                                    const float* __restrict__ alpha,
                                    __nv_bfloat16* __restrict__ out, int T,
                                    int S, int C, int replicate,
                                    long long total) {
  const int cv = C / 8;
  const float a = alpha[0];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * 8;
    const long long pos = i / cv;  // (b * T + t) * S + sp
    const long long bt = pos / S;
    const int sp = (int)(pos % S);
    const int t = (int)(bt % T);
    // the previous frame's row, or none (zero mode at t = 0)
    const long long prev = t > 0 ? pos - S : (replicate ? pos : -1);
    float sv[8], y[2][8];
    vt::unpack8(vt::ld_u4(s + pos * C + c), sv);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      vt::unpack8(vt::ld_u4(ycur + pos * ld + p * C + c), y[p]);
      if (prev >= 0) {
        float f[8];
        vt::unpack8(vt::ld_u4(yprev + prev * ld + p * C + c), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[p][e] += f[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[p][e] = a * sv[e] + (1.f - a) * (y[p][e] + bias[c + e]);
      *reinterpret_cast<uint4*>(out + ((2 * bt + p) * S + sp) * C + c) =
          vt::pack8(y[p]);
    }
  }
}

}  // namespace

extern "C" int vt_parity_blend(const void* s, const void* ycur,
                               const void* yprev, const void* bias,
                               const void* alpha, void* out, int ld, int B,
                               int T, int S, int C, int replicate,
                               void* stream) {
  const long long total = (long long)B * T * S * (C / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  parity_blend_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(ycur),
      static_cast<const __nv_bfloat16*>(yprev), ld,
      static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<__nv_bfloat16*>(out), T, S, C, replicate, total);
  return (int)cudaGetLastError();
}
