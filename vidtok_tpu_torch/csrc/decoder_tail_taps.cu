// Kernel D': decoder tail with per-tap products on the tensor cores.
//
// Replaces vidtok_tpu/ops/pallas/decoder_tail.py:160 _kernel, the body that
// decoder_tail_rgb (pallas_call at :308) runs with tap_pack=False:
//
//   out[b,t] = bias + sum_{j,dy,dx,c} act(x[b, t-2+j, y+dy-1, x+dx-1, c])
//                                     * w[j, dy, dx, c, :]
//
// act is the exact LayerNorm + SiLU of _ln_silu (:42): the mean, then the
// mean of (x - mean)^2, the affine result rounded to bf16, then y *
// sigmoid(y) rounded to bf16. Activated taps outside the frame read zero
// (:177-192); frames before 0 are frame 0 (replicate) or skipped (zero,
// :197-213). Output [B, T, H, W, 3] bf16; w is [3, 3, 3, C, 3] bf16.
//
// Bound on the H100: reading x. The 27 tap products are 2 * 27 * 8 * C
// FLOP per position with Cout padded to 8: about 108 FLOP per input byte
// at C = 128, under the 295 where the tensor cores become the limit. The
// exp of the activation is the largest share of the rest.
//
// Design: one 256-thread block per 8 x 16 output tile of one clip walks
// time. Each frame's 10 x 18 halo tile is loaded once (a half-warp per
// position, one 16-byte vector per lane, the loads of frame t+1 issued
// before the products of frame t so that they overlap), activated once,
// and stored to a ring of three activated frames in shared memory, as the
// TPU kernel's ring_ref. Positions are padded by 8 channels so that the
// 8 rows of an ldmatrix fall in distinct banks. Each warp owns one output
// row (16 positions, one m16 tile) and runs the 27 taps x C/16 products
// with mma.sync m16n8k16 (bf16 in, f32 accumulate), Cout padded 3 -> 8 as
// the TPU pads to _PAD_CO, the weights in shared memory in fragment order.
// Shared memory bounds it: the ring (3 x 180 x (C + 8) bf16) and the
// weights (27 x 16 C bytes) take 202 KB at C = 128, the largest C it takes,
// so one block runs per SM; a [1, 20, 256, 256, 128] call has 512 blocks.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 16;           // output tile: rows x columns
constexpr int HY = TH + 2, HX = TW + 2;  // halo tile
constexpr int HALO = HY * HX;
constexpr int THREADS = 32 * TH;         // one warp per output row
constexpr int PER_HW = (HALO + THREADS / 16 - 1) / (THREADS / 16);
constexpr int COUT = 3;
constexpr int MAX_C = 128;               // one 16-byte vector per lane

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The half-warp ``hw``'s positions of a frame's halo tile: lane ``hl``'s
// 16-byte vector of each, zeros outside the frame.
__device__ __forceinline__ void load_halo(uint4 (&v)[PER_HW],
                                          const __nv_bfloat16* __restrict__ frame,
                                          int hw, int hl, bool lane_c, int x0,
                                          int y0, int H, int W, int C) {
#pragma unroll
  for (int k = 0; k < PER_HW; ++k) {
    const int p = hw + k * (THREADS / 16);
    const int gy = y0 - 1 + p / HX, gx = x0 - 1 + p % HX;
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (p < HALO && lane_c && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v[k] = vt::ld_u4(frame + ((long long)gy * W + gx) * C + hl * 8);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    tail_taps_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ g, const float* __restrict__ b,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int T, int H, int W,
                     int C, int replicate) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = C + 8;  // bf16 per ring position
  const int KS = C / 16;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  uint2* wsm = reinterpret_cast<uint2*>(smem + 3 * HALO * SP * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = tid >> 4, hl = tid & 15;  // half-warp, lane in it
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const long long clip = (long long)blockIdx.z * T;

  // weights in mma B-fragment order: [tap][k step][lane] -> (b0, b1)
  for (int i = tid; i < 27 * KS * 32; i += THREADS) {
    const int l = i & 31, ks = (i >> 5) % KS, tap = (i >> 5) / KS;
    const int n = l >> 2, k = ks * 16 + (l & 3) * 2;
    uint2 v = make_uint2(0u, 0u);
    if (n < COUT) {
      const __nv_bfloat16* wp = w + ((long long)tap * C + k) * COUT + n;
      v.x = pack2(wp[0], wp[COUT]);
      v.y = pack2(wp[8 * COUT], wp[9 * COUT]);
    }
    wsm[i] = v;
  }
  const bool lane_c = hl * 8 < C;  // this lane holds channels [8hl, 8hl+8)
  float g8[8], b8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    g8[e] = lane_c ? g[hl * 8 + e] : 0.f;
    b8[e] = lane_c ? b[hl * 8 + e] : 0.f;
  }

  uint4 v[PER_HW];
  load_halo(v, x + clip * H * W * C, hw, hl, lane_c, x0, y0, H, W, C);
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // every warp is done with the slot of frame t - 3
    __nv_bfloat16* slot = ring + (t % 3) * HALO * SP;
#pragma unroll
    for (int k = 0; k < PER_HW; ++k) {
      const int p = hw + k * (THREADS / 16);
      const int gy = y0 - 1 + p / HX, gx = x0 - 1 + p % HX;
      float f[8];
      vt::unpack8(v[k], f);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
      const float mu = half_warp_sum(s) / C;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += lane_c ? (f[e] - mu) * (f[e] - mu) : 0.f;
      const float rs = 1.f / sqrtf(half_warp_sum(d) / C + vt::kLnEps);
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __bfloat162float(
            __float2bfloat16((f[e] - mu) * rs * g8[e] + b8[e]));
        f[e] = inside ? y / (1.f + __expf(-y)) : 0.f;
      }
      if (p < HALO && lane_c)
        *reinterpret_cast<uint4*>(slot + p * SP + hl * 8) = vt::pack8(f);
    }
    __syncthreads();  // frame t is in its slot
    if (t + 1 < T)
      load_halo(v, x + (clip + t + 1) * H * W * C, hw, hl, lane_c, x0, y0, H, W, C);

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < 3; ++j) {
      int src = t - 2 + j;
      if (src < 0) {
        if (!replicate) continue;  // uniform over the block
        src = 0;
      }
      const __nv_bfloat16* fr = ring + (src % 3) * HALO * SP;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        // ldmatrix rows: lanes 0-15 give positions 0-15 at k, 16-31 at k+8
        const unsigned addr = (unsigned)__cvta_generic_to_shared(
            fr + ((warp + dy) * HX + (lane & 15) + dx) * SP + (lane >> 4) * 8);
        const uint2* wt = wsm + (j * 9 + tap) * KS * 32 + lane;
        for (int ks = 0; ks < KS; ++ks) {
          unsigned a0, a1, a2, a3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
              : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
              : "r"(addr + ks * 32));
          const uint2 bb = wt[ks * 32];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
              : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bb.x), "r"(bb.y));
        }
      }
    }
    // acc: columns 2(lane&3), +1 of positions lane>>2 and lane>>2 + 8
    const int oy = y0 + warp, n0 = (lane & 3) * 2;
    if (oy < H && n0 < COUT) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ox = x0 + (lane >> 2) + 8 * r;
        if (ox >= W) continue;
        __nv_bfloat16* o = out + (((clip + t) * H + oy) * W + ox) * COUT;
        o[n0] = __float2bfloat16(acc[2 * r] + bias[n0]);
        if (n0 + 1 < COUT) o[n0 + 1] = __float2bfloat16(acc[2 * r + 1] + bias[n0 + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int vt_decoder_tail_rgb_taps(const void* x, void* out, const void* g,
                                        const void* b, const void* w,
                                        const void* bias, int B, int T, int H,
                                        int W, int C, int replicate,
                                        void* stream) {
  if (C % 16 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int smem = 3 * HALO * (C + 8) * 2 + 27 * C * 16;
  cudaFuncSetAttribute(tail_taps_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tail_taps_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), T, H,
      W, C, replicate);
  return (int)cudaGetLastError();
}
