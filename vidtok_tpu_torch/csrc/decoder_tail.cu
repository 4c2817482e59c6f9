// Kernels D and D': the decoder tail, LayerNorm + SiLU + causal 3x3x3 conv
// C -> RGB, one kernel template with two entries.
//
// Replaces vidtok_tpu/ops/pallas/decoder_tail.py:245 decoder_tail_rgb
// (pallas_call at :308): D (vt_decoder_tail_rgb) its default body
// _kernel_tap_pack (:53) with the kernels' fast LN+SiLU (ln_silu,
// common.cuh), D' (vt_decoder_tail_rgb_taps) its body with tap packing off,
// _kernel (:160), with the exact one of _ln_silu (:42): the mean, then the
// mean of (x - mean)^2, the affine result rounded to bf16, then y *
// sigmoid(y) rounded to bf16. Both compute
//
//   out[b,t] = bias + sum_{j,dy,dx,c} act(x[b, t-2+j, y+dy-1, x+dx-1, c])
//                                     * w[co, c, j, dy, dx]
//
// with activated taps outside the frame reading zero (:177-192) and frames
// before 0 being frame 0 (replicate) or absent (zero, :197-213). x is
// [B, T, H, W, C] bf16, C in {64, 128}; out [B, T, H, W, 3] bf16.
//
// Bound on the H100: reading x. The function is 2 * 81 * C FLOP per
// position against 2C bytes read, 81 FLOP/byte, under the 295 where the
// tensor cores become the limit; [1, 20, 256, 256, 128] moves 343 MB,
// 0.103 ms at 3.35 TB/s. What stands between a kernel and that bound is
// reading each input frame once, activating it once (a tanh, or an exp and
// a reciprocal, per element on the SFU, and the statistics' shuffles), and
// keeping the products off the CUDA cores. The activation is the largest
// share: it needs more warps in flight than one block of two warpgroups
// gives it, so it has warpgroups of its own.
//
// Design (the plan, ops/kernels/plan.py tail_plan, picks the run and the
// stages; the entry refuses another patch or C). One block of 800 threads
// per (8 x 14 output patch, clip, run of frames) walks time, one block per
// SM (the ring of boxes takes 160 KB of shared memory), in three roles
// chained by mbarriers per stage (full: loaded, act: activated, empty:
// multiplied):
// * A producer warp issues, per input frame, C / 64 TMA boxes of the
//   patch's 10 x 16 halo (128-byte swizzle, zero fill outside the frame)
//   into a ring of up to 4 stages, so up to 3 frames (120 KB at C = 128)
//   are in flight.
// * Five warpgroups activate each box in place as it lands, up to a ring
//   ahead of the products: 16 lanes per position (8 per 64-channel slice),
//   LN statistics in f32 registers by shuffles (no statistics pass), the
//   bf16 result written back in the swizzled layout the products read;
//   positions outside the frame are then set to zero (TMA's zero fill pads
//   the raw input, and ln_silu(0) != 0). Each thread fences the async
//   proxy and arrives on the stage's act barrier. The role is taken from a
//   warp-uniform value, so the compiler emits the shuffles without
//   collective fix-ups. Five is measured: four and six (which spills at its
//   64 registers) are slower.
// * One warpgroup multiplies and gathers. The products run on the tensor
//   cores: wgmma m64n32k16, A the activated box, B the weights
//   [dy][n = 9j + 3dx + co][C], 27 columns padded to 32. A dy shift is 16
//   rows of A, a whole number of 1024-byte swizzle atoms, so two chains
//   (GEMM rows 0-63 and 64-127) of 3 dy x C / 16 products each give
//   P[m, n], m = 16 oy + hx the row of halo column hx of output row oy.
//   When they are done the stage goes back to the producer, P goes to
//   shared memory (two buffers, one barrier of the warpgroup a frame), and
//   112 threads, one per output position, gather the 3 dx neighbours of
//   their position into a ring of three f32 output accumulators in
//   registers: outputs f (j = 2), f + 1 (j = 1), f + 2 (j = 0). Output f is
//   then complete; it is written with the bias added, rounded to bf16
//   once, and the ring turns. replicate adds frame 0's partials under
//   j = 0 and 1 to output 0 and under j = 0 to output 1; zero adds nothing.
// * The ring starts at zero in every block; a run starting at t0 > 0
//   first reads frames t0 - 2 and t0 - 1 and writes nothing for them.
// Offsets into x and out are 64-bit; TMA coordinates are per dimension.
//
// f32 (vt_decoder_tail_rgb_f32, kernel D on f32 activations): x and out
// f32, the same function with f32 products on the CUDA cores, exact to f32
// rounding. It is not a form of the template above: an f32 box takes
// twice a bf16 box's bytes and its activation, as the f32 scheme's three
// bf16 pieces (wgmma_conv.cuh), three times, so a stage of the 10 x 16
// halo at C = 128 would hold 80 KB of raw box and 120 KB of pieces, and
// the ring needs two stages in 227 KB. Two launches: act_rows_kernel's
// kRowF32 form writes LN+SiLU of x (two-pass statistics, the sigmoid
// through tanhf) to an f32 scratch, then tail_f32_kernel: one block of 128
// threads per (16 x 32 output patch, clip, output frame), the frame
// fastest in launch order so the blocks that read a frame's halo run
// together and share it in L2. For each time tap j it walks the channels
// 16 at a time: the 18 x 34 halo of frame t - 2 + j (zero outside the
// frame: the conv's padding after the activation) into shared memory,
// channel-major, and each thread accumulates 4 neighbouring outputs x 3
// channels over the 3 x 3 taps, its 6 halo columns loaded once a
// (channel, dy) for 36 FMAs; the tap's weights [3 dy][C][12] (9 used: dx,
// co) are read as 16-byte broadcasts. Frames before 0 are skipped (zero)
// or frame 0 (replicate). Its floor on the CUDA cores is the FMAs, 81 C a
// position x 3 channels at the f32 rate (67 TFLOP/s); the function's bound
// on the card is the f32 tensors' bytes (the FLOP at the f32 scheme's 989
// / 6 TFLOP/s take less), which a tensor-core form with a smaller patch
// would approach. D' in f32 differs from D only in the sigmoid's form, so
// it is to take this path with the exact row form, not a third one. The
// plan is plan.py's tail_plan_f32.
#include "wgmma_conv.cuh"

namespace {

using namespace vt;
using namespace vt::wg;

constexpr int TH = 8, TW = 14;             // output patch
constexpr int HY = TH + 2, HX = TW + 2;    // halo box: HX = 16 rows of A per dy
constexpr int HALO = HY * HX;              // 160 positions
constexpr int M = TH * HX;                 // 128 GEMM rows, two m64 tiles
constexpr int NCOL = 27, BN = 32;          // (j, dx, co) columns, padded
constexpr int OUTS = TH * TW;              // 112 output positions
constexpr int COUT = 3;
constexpr int ACT = 5 * 128;               // activating threads, five warpgroups,
constexpr int MMA = ACT;                   // then one warpgroup that multiplies
constexpr int PRODUCER = ACT + 128;        // and gathers, then a producer warp
constexpr int THREADS = PRODUCER + 32;
constexpr int SLICE = HALO * 128;          // one 64-channel slice of a box
constexpr int WTILE = BN * 128;            // one (dy, slice) weight tile
constexpr int PBUF = M * NCOL * 4;         // one f32 partial buffer
constexpr int kErrTailPlan = 1004;

__host__ __device__ constexpr int smem_bytes(int kh, int stages) {
  return 1024 + stages * kh * SLICE + 3 * kh * WTILE + 2 * PBUF + 24 * stages;
}

struct TailArgs {
  const float* g;             // [C] norm scale
  const float* b;             // [C] norm bias
  const __nv_bfloat16* w;     // [3 dy][BN][C], row n = 9j + 3dx + co
  const float* bias;          // [3]
  __nv_bfloat16* out;         // [B, T, H, W, 3]
  int T, H, W;
  int replicate;
  int tiles_x, tiles_y, run, runs, stages;
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 32] += A[64 x 16] B[16 x 32], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// LN + SiLU of one frame's halo box in place. LPP = 8 * KH lanes hold a
// position, lane l its 16-byte chunk l & 7 of slice l >> 3 (channels
// 64 (l >> 3) + 8 (l & 7) + e), read and written at the chunk's swizzled
// place. A thread loads all its positions, then reduces their statistics
// together (independent shuffles in flight), then activates them. The fast
// form folds the affine and the SiLU into h = 0.5 y = (x rs - mu rs) hg +
// hb, silu(y) = h tanh(h) + h (hg, hb: half the norm scale and bias);
// ln_silu computes the same in other steps.
template <bool EXACT, int KH>
__device__ __forceinline__ void activate(unsigned char* box, int tid, const float (&g8)[8],
                                         const float (&b8)[8], int y0, int x0, int H, int W,
                                         int C) {
  constexpr int LPP = 8 * KH, GROUPS = ACT / LPP;
  constexpr int ITER = (HALO + GROUPS - 1) / GROUPS;
  const int grp = tid / LPP, l = tid % LPP, chunk = l & 7;
  unsigned char* slice = box + (l >> 3) * SLICE;
  uint4 v[ITER];
  float s[ITER], q[ITER];
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int r = k * GROUPS + grp;
    v[k] = r < HALO ? *reinterpret_cast<const uint4*>(slice + r * 128 + ((chunk ^ (r & 7)) << 4))
                    : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    float f[8];
    unpack8(v[k], f);
    s[k] = q[k] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[k] += f[e];
      q[k] += f[e] * f[e];
    }
  }
#pragma unroll
  for (int o = LPP / 2; o; o >>= 1)
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      if (!EXACT) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
    }
  if (EXACT) {  // the mean of squared deviations, a second reduction
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      float f[8];
      unpack8(v[k], f);
      const float mu = s[k] / C;
      q[k] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) q[k] += (f[e] - mu) * (f[e] - mu);
    }
#pragma unroll
    for (int o = LPP / 2; o; o >>= 1)
#pragma unroll
      for (int k = 0; k < ITER; ++k) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
  }
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int r = k * GROUPS + grp;
    const int gy = y0 - 1 + r / HX, gx = x0 - 1 + r % HX;
    float f[8];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      unpack8(v[k], f);
      const float mu = s[k] / C;
      if (EXACT) {
        const float rs = 1.f / sqrtf(q[k] / C + kLnEps);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = __bfloat162float(__float2bfloat16((f[e] - mu) * rs * g8[e] + b8[e]));
          f[e] = __fdividef(y, 1.f + __expf(-y));
        }
      } else {
        const float rs = rsqrtf(fmaxf(q[k] / C - mu * mu, 0.f) + kLnEps), nmr = -mu * rs;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float h = fmaf(fmaf(f[e], rs, nmr), g8[e], b8[e]);
          f[e] = fmaf(h, tanh_fast(h), h);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;  // the conv's SAME padding, after the activation
    }
    if (r < HALO)
      *reinterpret_cast<uint4*>(slice + r * 128 + ((chunk ^ (r & 7)) << 4)) = pack8(f);
  }
}

template <bool EXACT, int KH>
__global__ void __launch_bounds__(THREADS, 1)
    tail_kernel(const __grid_constant__ CUtensorMap map_x, const TailArgs p) {
  constexpr int C = 64 * KH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int S = p.stages;
  constexpr int kStage = KH * SLICE;
  unsigned char* wsm = smem + S * kStage;
  float* pbuf = reinterpret_cast<float*>(wsm + 3 * KH * WTILE);
  // per stage: full (loaded), act (activated), empty (multiplied); bar + 8s
  const uint32_t full = base + S * kStage + 3 * KH * WTILE + 2 * PBUF;
  const uint32_t act = full + 8 * S, empty = act + 8 * S;

  // this block's patch, clip and run (plan.tail_block)
  int q = blockIdx.x;
  const int x0 = (q % p.tiles_x) * TW;
  q /= p.tiles_x;
  const int y0 = (q % p.tiles_y) * TH;
  q /= p.tiles_y;
  const int clip = q / p.runs;
  const int t0 = (q % p.runs) * p.run;
  const int t1 = min(p.T, t0 + p.run);
  const int f0 = max(t0 - 2, 0);
  const int frames = t1 - f0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(act + 8 * s, ACT);  // every activating thread, after its fence
      mbar_init(empty + 8 * s, 4);  // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights, once, in the swizzled K-major layout of the B operand
  for (int i = tid; i < 3 * BN * (C / 8); i += THREADS) {
    const int row = i / (C / 8), ch = i % (C / 8);  // row = dy * BN + n
    const int dy = row / BN, n = row % BN;
    *reinterpret_cast<uint4*>(wsm + (dy * KH + ch / 8) * WTILE + n * 128 +
                              (((ch & 7) ^ (n & 7)) << 4)) =
        ld_u4(p.w + (long long)row * C + ch * 8);
  }
  fence_async_smem();
  __syncthreads();

  // the role by warp, uniform across the warp as the compiler sees it (no
  // collective fix-up around the shuffles that follow)
  const int wid = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (wid >= PRODUCER / 32) {
    // producer: one thread issues every load
    if (tid == PRODUCER) {
      prefetch_map(&map_x);
      for (int i = 0; i < frames; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);  // the first round passes
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kStage);
#pragma unroll
        for (int h = 0; h < KH; ++h)
          tma_5d(base + s * kStage + h * SLICE, &map_x, bar, 64 * h, x0 - 1, y0 - 1, f0 + i, clip);
      }
    }
    return;
  }

  if (wid < ACT / 32) {
    // activators: LN + SiLU of each frame's box in place, up to S frames
    // ahead of the products
    float g8[8], b8[8];  // this thread's channels' norm scale and bias (fast: halved)
    const int c = 64 * ((tid % (8 * KH)) >> 3) + 8 * (tid & 7);
    const float half = EXACT ? 1.f : 0.5f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g8[e] = half * p.g[c + e];
      b8[e] = half * p.b[c + e];
    }
    for (int i = 0; i < frames; ++i) {
      const int s = i % S;
      mbar_wait(full + 8 * s, (i / S) & 1);
      activate<EXACT, KH>(smem + s * kStage, tid, g8, b8, y0, x0, p.H, p.W, C);
      fence_async_smem();  // the products read the box through the async proxy
      mbar_arrive(act + 8 * s);
    }
    return;
  }

  // the multiplying warpgroup: products, then the gather
  const int mt = tid - MMA, warp = mt >> 5, lane = mt & 31;
  const bool gatherer = mt < OUTS;  // output position (oy, ox), GEMM row m at dx = 0
  const int oy = mt / TW, ox = mt % TW, m = oy * HX + ox;
  float bias[COUT], o0[COUT], o1[COUT], o2[COUT];  // the ring: outputs f, f+1, f+2
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    bias[co] = p.bias[co];
    o0[co] = o1[co] = o2[co] = 0.f;
  }
  const bool write_pos = gatherer && y0 + oy < p.H && x0 + ox < p.W;
  const long long hw = (long long)p.H * p.W;
  __nv_bfloat16* opos = p.out + ((long long)clip * p.T * hw + (long long)(y0 + oy) * p.W +
                                 (x0 + ox)) * COUT;
  const uint32_t wb = smem_u32(wsm);

  for (int i = 0; i < frames; ++i) {
    const int f = f0 + i, s = i % S;
    mbar_wait(act + 8 * s, (i / S) & 1);
    // P[m, n] = sum_dy sum_c a[m + 16 dy, c] w[dy, n, c]: rows 0-63 in acc0,
    // 64-127 in acc1, two chains issued in turns
    float acc0[16], acc1[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc0[k] = acc1[k] = 0.f;
    fence_acc(acc0);
    fence_acc(acc1);
    wgmma_fence();
    const uint32_t a = base + s * kStage;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int h = 0; h < KH; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t dw = smem_desc(wb + (dy * KH + h) * WTILE + 32 * k);
          const uint32_t ak = a + h * SLICE + dy * HX * 128 + 32 * k;
          wgmma_n32(acc0, smem_desc(ak), dw);
          wgmma_n32(acc1, smem_desc(ak + 64 * 128), dw);
        }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the box

    // acc -> P: rows 16 warp + (lane >> 2) (+ 8, + 64), columns 8k + 2 (lane & 3)
    // (+ 1); columns from NCOL on are padding
    float* pb = pbuf + (i & 1) * (M * NCOL);
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * k + 2 * (lane & 3) + e;
        if (n < NCOL) {
          pb[r0 * NCOL + n] = acc0[4 * k + e];
          pb[(r0 + 8) * NCOL + n] = acc0[4 * k + 2 + e];
          pb[(r0 + 64) * NCOL + n] = acc1[4 * k + e];
          pb[(r0 + 72) * NCOL + n] = acc1[4 * k + 2 + e];
        }
      }
    named_sync(1, 128);  // P is whole

    if (gatherer) {
      const bool rep0 = p.replicate && f == 0;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* pr = pb + (m + dx) * NCOL + 3 * dx;
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          const float a0 = pr[co], a1 = pr[9 + co], a2 = pr[18 + co];  // j = 0, 1, 2
          o0[co] += a2;
          o1[co] += a1;
          o2[co] += a0;
          if (rep0) {  // frames -2 and -1 are frame 0
            o0[co] += a0 + a1;
            o1[co] += a0;
          }
        }
      }
      if (f >= t0 && write_pos) {
        __nv_bfloat16* o = opos + (long long)f * hw * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co) o[co] = __float2bfloat16(o0[co] + bias[co]);
      }
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        o0[co] = o1[co];
        o1[co] = o2[co];
        o2[co] = 0.f;
      }
    }
  }
}

// The map of x [B, T, H, W, C] for loads of one frame's halo box, 64
// channels at a time.
int tail_map(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C) {
  const unsigned long long dims[5] = {(unsigned long long)C, (unsigned long long)W,
                                      (unsigned long long)H, (unsigned long long)T,
                                      (unsigned long long)B};
  const unsigned box[5] = {64, HX, HY, 1, 1};
  return encode_map(map, x, 5, dims, box);
}

template <bool EXACT>
int launch_tail(const void* x, void* out, const void* g, const void* b, const void* w,
                const void* bias, int B, int T, int H, int W, int C, int replicate, int th,
                int tw, int run, int stages, int smem, int grid, void* stream) {
  const int kh = C / 64;
  if ((C != 64 && C != 128) || th != TH || tw != TW || B < 1 || T < 1 || H < 1 || W < 1 ||
      run < 1 || stages < 2 || smem < smem_bytes(kh, stages))
    return kErrTailPlan;
  TailArgs p{};
  p.g = static_cast<const float*>(g);
  p.b = static_cast<const float*>(b);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.T = T;
  p.H = H;
  p.W = W;
  p.replicate = replicate;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  p.run = run;
  p.runs = (T + run - 1) / run;
  p.stages = stages;
  if ((long long)B * p.tiles_x * p.tiles_y * p.runs != grid) return kErrTailPlan;
  CUtensorMap map;
  const int e = tail_map(&map, x, B, T, H, W, C);
  if (e) return e;
  auto kernel = kh == 2 ? tail_kernel<EXACT, 2> : tail_kernel<EXACT, 1>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel D: the fast LN+SiLU (ln_silu, common.cuh).
extern "C" int vt_decoder_tail_rgb(const void* x, void* out, const void* g, const void* b,
                                   const void* w, const void* bias, int B, int T, int H, int W,
                                   int C, int replicate, int th, int tw, int run, int stages,
                                   int smem, int grid, void* stream) {
  return launch_tail<false>(x, out, g, b, w, bias, B, T, H, W, C, replicate, th, tw, run,
                            stages, smem, grid, stream);
}

// Kernel D': the exact LN+SiLU of decoder_tail.py:42 _ln_silu.
extern "C" int vt_decoder_tail_rgb_taps(const void* x, void* out, const void* g, const void* b,
                                        const void* w, const void* bias, int B, int T, int H,
                                        int W, int C, int replicate, int th, int tw, int run,
                                        int stages, int smem, int grid, void* stream) {
  return launch_tail<true>(x, out, g, b, w, bias, B, T, H, W, C, replicate, th, tw, run,
                           stages, smem, grid, stream);
}

namespace {

constexpr int FTH = 16, FTW = 32, FPX = 4;   // output patch; x outputs a thread
constexpr int FTHREADS = FTH * FTW / FPX;   // 128
constexpr int FCK = 16;                     // channels of a halo chunk
constexpr int FHY = FTH + 2, FHX = FTW + 2, FLD = 36;  // halo rows, columns, row stride
constexpr int FWLD = 12;                    // a (dy, c) weight row: 9 used

constexpr int tail_f32_smem(int C) { return (FCK * FHY * FLD + 3 * C * FWLD) * 4; }

struct TailF32Args {
  const float* act;   // [B, T, H, W, C] activated
  const float* w;     // [3 j][3 dy][C][FWLD], column dx * 3 + co
  const float* bias;  // [3]
  float* out;         // [B, T, H, W, 3]
  int T, H, W, C, replicate, tiles_x, tiles_y;
};

__global__ void __launch_bounds__(FTHREADS) tail_f32_kernel(const TailF32Args p) {
  extern __shared__ float fsm[];
  float* halo = fsm;                       // [FCK][FHY][FLD]
  float* wsm = fsm + FCK * FHY * FLD;      // [3 dy][C][FWLD], this tap's
  int q = blockIdx.x;
  const int t = q % p.T;
  q /= p.T;
  const int x0 = (q % p.tiles_x) * FTW;
  q /= p.tiles_x;
  const int y0 = (q % p.tiles_y) * FTH;
  const int clip = q / p.tiles_y;
  const int tid = threadIdx.x, oy = tid / (FTW / FPX), ox = (tid % (FTW / FPX)) * FPX;
  float acc[FPX][3];
#pragma unroll
  for (int i = 0; i < FPX; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
  for (int j = 0; j < 3; ++j) {
    int f = t - 2 + j;
    if (f < 0) {
      if (!p.replicate) continue;  // uniform across the block
      f = 0;
    }
    __syncthreads();  // the previous tap's weights and halo are read
    for (int i = tid; i < 3 * p.C * FWLD; i += FTHREADS)
      wsm[i] = p.w[(long long)j * 3 * p.C * FWLD + i];
    const float* frame = p.act + ((long long)clip * p.T + f) * p.H * p.W * p.C;
    for (int c0 = 0; c0 < p.C; c0 += FCK) {
      __syncthreads();
      for (int i = tid; i < FHY * FHX * (FCK / 4); i += FTHREADS) {
        const int v = i % (FCK / 4), pos = i / (FCK / 4);
        const int hy = pos / FHX, hx = pos - hy * FHX;
        const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
          a = *reinterpret_cast<const float4*>(frame + ((long long)gy * p.W + gx) * p.C + c0 +
                                               4 * v);
        float* h = halo + (4 * v * FHY + hy) * FLD + hx;
        h[0] = a.x;
        h[FHY * FLD] = a.y;
        h[2 * FHY * FLD] = a.z;
        h[3 * FHY * FLD] = a.w;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < FCK; ++c)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* row = halo + (c * FHY + oy + dy) * FLD + ox;
          const float4 a4 = *reinterpret_cast<const float4*>(row);
          const float2 a2 = *reinterpret_cast<const float2*>(row + 4);
          const float a[FPX + 2] = {a4.x, a4.y, a4.z, a4.w, a2.x, a2.y};
          const float4* wr = reinterpret_cast<const float4*>(wsm + (dy * p.C + c0 + c) * FWLD);
          const float4 w0 = wr[0], w1 = wr[1], w2 = wr[2];
          const float w[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
#pragma unroll
          for (int i = 0; i < FPX; ++i)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int co = 0; co < 3; ++co)
                acc[i][co] = fmaf(a[i + dx], w[dx * 3 + co], acc[i][co]);
        }
    }
  }
  const int y = y0 + oy;
  if (y >= p.H) return;
  float* o = p.out + ((((long long)clip * p.T + t) * p.H + y) * p.W) * 3;
#pragma unroll
  for (int i = 0; i < FPX; ++i) {
    const int x = x0 + ox + i;
    if (x < p.W)
#pragma unroll
      for (int co = 0; co < 3; ++co) o[(long long)x * 3 + co] = acc[i][co] + p.bias[co];
  }
}

}  // namespace

// Kernel D in f32: x, act (the [B, T, H, W, C] f32 scratch), out f32; w the
// [3 j][3 dy][C][12] f32 weight (ops/kernels/decoder_tail.py:
// tail_operands_f32); th, tw, smem and grid from plan.py's tail_plan_f32.
extern "C" int vt_decoder_tail_rgb_f32(const void* x, void* act, void* out, const void* g,
                                       const void* b, const void* w, const void* bias, int B,
                                       int T, int H, int W, int C, int replicate, int th,
                                       int tw, int smem, int grid, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((C != 64 && C != 128) || th != FTH || tw != FTW || B < 1 || T < 1 || H < 1 || W < 1 ||
      smem < tail_f32_smem(C))
    return kErrTailPlan;
  TailF32Args p{static_cast<const float*>(act), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<float*>(out), T, H, W, C,
                replicate, (W + FTW - 1) / FTW, (H + FTH - 1) / FTH};
  if ((long long)B * p.tiles_y * p.tiles_x * T != grid) return kErrTailPlan;
  const RowArgs r{x, static_cast<const float*>(g), static_cast<const float*>(b), act};
  int e = launch_act_rows<false, kRowF32>(r, (long long)B * T * H * W, C, s);
  if (e) return e;
  const cudaError_t a =
      cudaFuncSetAttribute(tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) return (int)a;
  tail_f32_kernel<<<grid, FTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}
