// Kernel D: decoder tail, LayerNorm + SiLU + causal 3x3x3 conv C -> RGB.
//
// Replaces vidtok_tpu/ops/pallas/decoder_tail.py:245 decoder_tail_rgb
// (pallas_call at :308), semantics of its default body _kernel_tap_pack
// (:53): out[b,t] = bias + sum_{j,dy,dx,c} act(x[b, t-2+j, y+dy-1, x+dx-1, c])
// * w[j,dy,dx,c,:], act = ln_silu rounded to bf16; out-of-frame taps read
// zero after the activation; frames before 0 are frame 0 (replicate) or
// skipped (zero). Output [B, T, H, W, 3] bf16.
//
// Bound on the H100: with 3 output channels the conv is 162 FLOP per input
// element per time tap, too narrow for tensor cores (the TPU padded N to
// 8/128 lanes to feed its MXU); it is bound by reading x and by the f32
// FMA and activation work.
//
// Design: after a per-position statistics pass, one 256-thread block per
// 16 x 16 output tile of one frame. For each time tap and each 16-channel
// chunk the block stages the activated 18 x 18 halo tile (zero outside
// the frame) and the chunk's 9 x 16 x 3 weights in shared memory; each
// thread then accumulates its position's 3 outputs in f32 registers. An
// input frame is activated once per (output frame, tap), three times in
// all, and read from L2 after the first.
#include "common.cuh"

namespace {

constexpr int TX = 16, TY = 16;
constexpr int HX = TX + 2, HY = TY + 2, HALO = HX * HY;
constexpr int CK = 16;
constexpr int COUT = 3;

__global__ void __launch_bounds__(TX * TY)
    tail_kernel(const __nv_bfloat16* __restrict__ x,
                const float2* __restrict__ stats, const float* __restrict__ g,
                const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                int T, int H, int W, int C, int replicate) {
  __shared__ float tile[CK][HALO];
  __shared__ float wsm[9 * CK * COUT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int bi = blockIdx.z / T, t = blockIdx.z % T;
  float acc[COUT] = {0.f, 0.f, 0.f};

  for (int j = 0; j < 3; ++j) {
    int sf = t + j - 2;
    if (sf < 0) {
      if (!replicate) continue;  // uniform over the block
      sf = 0;
    }
    const long long fbase = ((long long)bi * T + sf) * H * W;
    for (int c0 = 0; c0 < C; c0 += CK) {
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < HALO * 2; idx += TX * TY) {
        const int pos = idx >> 1, half = idx & 1;
        const int hy = y0 - 1 + pos / HX, hx = x0 - 1 + pos % HX;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (hy >= 0 && hy < H && hx >= 0 && hx < W) {
          const long long row = fbase + (long long)hy * W + hx;
          const float2 st = stats[row];
          const int c = c0 + half * 8;
          vt::unpack8(vt::ld_u4(x + row * C + c), f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = __bfloat162float(__float2bfloat16(
                vt::ln_silu(f[e], st.x, st.y, g[c + e], b[c + e])));
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) tile[half * 8 + e][pos] = f[e];
      }
      for (int idx = tid; idx < 9 * CK * COUT; idx += TX * TY) {
        const int tap = idx / (CK * COUT), rem = idx % (CK * COUT);
        const int c = rem / COUT, co = rem % COUT;
        wsm[idx] = __bfloat162float(
            w[(((long long)j * 9 + tap) * C + c0 + c) * COUT + co]);
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int pos = (ty + tap / 3) * HX + tx + tap % 3;
        const float* wt = wsm + tap * CK * COUT;
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float a = tile[c][pos];
          acc[0] += a * wt[c * COUT];
          acc[1] += a * wt[c * COUT + 1];
          acc[2] += a * wt[c * COUT + 2];
        }
      }
    }
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < H && ox < W) {
    __nv_bfloat16* o =
        out + (((long long)bi * T + t) * H * W + (long long)oy * W + ox) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) o[co] = __float2bfloat16(acc[co] + bias[co]);
  }
}

}  // namespace

extern "C" int vt_decoder_tail_rgb(const void* x, void* out, void* stats,
                                   const void* g, const void* b, const void* w,
                                   const void* bias, int B, int T, int H,
                                   int W, int C, int replicate, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* st = static_cast<float2*>(stats);
  vt::launch_ln_stats(xb, st, (long long)B * T * H * W, C, s);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B * T);
  tail_kernel<<<grid, dim3(TX, TY), 0, s>>>(
      xb, st, static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), T, H, W, C, replicate);
  return (int)cudaGetLastError();
}
