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
// [B, T, H, W, C] bf16, C % 8 == 0 up to 1024; out [B, T, H, W, 3] bf16
// (f32 forms below: f32).
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
// stages; the entry refuses another patch or C; C up to 128 channels, see
// "Channels" below for more). One block of 800 threads
// per (8 x 14 output patch, clip, run of frames) walks time, one block per
// SM (the ring of boxes takes 160 KB of shared memory), in three roles
// chained by mbarriers per stage (full: loaded, act: activated, empty:
// multiplied):
// * A producer warp issues, per input frame, ceil(C / 64) TMA boxes of the
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
// Channels. C % 8 == 0: the last 64-channel box of a position is partial,
// TMA's zero fill past C, and the statistics divide by the true C (the
// zeros add nothing to the sums; the exact form leaves their deviations
// out). ln_silu(0) != 0 where the norm bias is not 0, so a channel past C
// must neither activate to anything nor meet a weight: its norm scale and
// bias are read as 0 (it activates to 0) and its rows of the resident
// weight tiles are written as zeros. Past TAIL_GROUP = 128 channels the
// halo boxes and the weights of all channels no longer fit shared memory
// beside a ring of stages (1024 channels: 320 KB a box), so the tail runs
// in groups of up to 128 channels, one launch each, behind a row pass that
// writes each position's two-pass LN statistics (act_rows_kernel's
// kRowStatsBf16 form): a group's launch activates its boxes from them and
// adds its channels' partial sums to an f32 accumulator [B, T, H, W, 3]
// (the first writes it, the last adds the bias and writes the output).
// Each group reads its channels of x once, so x is read twice in all, as
// the f32 form reads it. Up to 128 channels nothing changes, and 64 and 128
// channels (whole boxes) run the form without masks (TailMode kFull).
//
// f32 (vt_decoder_tail_rgb_f32 and vt_decoder_tail_rgb_taps_f32: D and D'
// on f32 activations, the same function in f32, the output not rounded;
// both activations f32 with two-pass statistics, D's SiLU through tanhf
// (ln_silu_f32), D''s through an exp and a reciprocal (ln_silu_exact_f32),
// their only difference in f32). The products run on the tensor cores
// under the f32 scheme of wgmma_conv.cuh: each operand as three bf16
// pieces (split3), the six products of total order at most 2 as extra K
// steps of the same m64n32k16 chains. The walk is tail_kernel's (one block
// of 800 threads per 8 x 14 patch and run of frames, tail_plan's runs),
// but a frame's halo box cannot be activated in place: its LN statistics
// need all C channels of a position before any piece exists, and a whole
// f32 box (80 KB at C = 128) with its pieces (120 KB) leaves no room for a
// second stage beside the resident weight pieces (72 KB). So two launches:
// act_rows_kernel's kRowStats form writes each position's (mean, rstd), 8
// bytes, reading x once; then tail_f32_kernel walks the frames in units of
// one 32-channel slice:
// * the producer loads a unit's raw f32 halo box (10 x 16 x 32, 20 KB,
//   128-byte swizzle, zero fill) into a ring of up to 4 raw stages;
// * the five activating warpgroups (4 threads a position, 8 channels each)
//   read it, apply LN from the position's statistics and the SiLU, zero the
//   positions outside the frame, and write the three pieces (3 x 10 KB,
//   rows of 64 B under the 64-byte swizzle) into one of two piece stages;
//   then they fence the async proxy and release both stages' barriers (the
//   raw stage only then: TMA's next load into it is an async-proxy write
//   that must follow their generic reads);
// * the multiplying warpgroup runs the six products x 3 dy x 2 K steps of
//   16 on both chains into the frame's accumulators, releasing a piece
//   stage once the slice after it is issued, then the dx gather and the
//   ring of tail_kernel, written in f32.
// A slice past C is partial (TMA's zero fill; its channels' norm scale and
// bias read as 0 and their weight rows written as zeros, as in the bf16
// form); past 128 channels the f32 form runs in groups of up to 128
// channels as the bf16 form does, the partial sums accumulated in ``out``.
// Shared memory at C = 128: 3 raw stages (60 KB), 2 piece stages (60 KB),
// the weight pieces [3][3 dy][32][C] (72 KB), the partial buffers (27 KB).
// x is read twice, the statistics' pass, then the boxes (160 halo positions
// for 112 outputs): 2.0-2.5x the function's bytes, as L2 catches the halo
// or not. The plan is plan.py's tail_plan_f32.
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
  const float2* stats;        // STATS: [B, T, H, W] (mean, rstd), the row pass's
  float* acc;                 // STATS: [B, T, H, W, 3] f32 partial sums
  int T, H, W;
  int replicate;
  int tiles_x, tiles_y, run, runs, stages;
  int C, c0;                  // the channels; this launch's first (its group)
  int first, last;            // this group is the first / the last
};

// One output position's value of output channel co: the block's partial
// sum ``v`` and, in a group after the first, the accumulator's; the last
// group adds the bias and writes the output (``out`` of type T), the others
// the accumulator.
template <typename T>
__device__ __forceinline__ void tail_store(T* out, float* acc, long long i, float v, float bias,
                                           int first, int last) {
  if (!first) v += acc[i];
  if (last) {
    if constexpr (sizeof(T) == 2) {
      out[i] = __float2bfloat16(v + bias);
    } else {
      out[i] = v + bias;
    }
  } else {
    acc[i] = v;
  }
}

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
// 64 (l >> 3) + 8 (l & 7) + e of the group), read and written at the
// chunk's swizzled place. A thread loads all its positions, then reduces
// their statistics together (independent shuffles in flight; STATS: reads
// each position's (mean, rstd) from ``stats``, the frame's [H, W] plane),
// then activates them. ``valid``: the thread's channels lie below C (else
// they are zeros, left out of the exact form's deviations, and g8 = b8 =
// 0 activate them to 0); ``inv_c`` = 1 / C (a power of two's is exact, so
// the released widths divide as a division would). The fast form folds the
// affine and the SiLU into
// h = 0.5 y = (x rs - mu rs) hg + hb, silu(y) = h tanh(h) + h (hg, hb:
// half the norm scale and bias); ln_silu computes the same in other steps.
template <bool EXACT, int KH, bool STATS>
__device__ __forceinline__ void activate(unsigned char* box, int tid, const float (&g8)[8],
                                         const float (&b8)[8], bool valid, int y0, int x0,
                                         int H, int W, float inv_c, const float2* stats) {
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
  if constexpr (STATS) {  // s = mean, q = rstd, from the row pass
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int r = k * GROUPS + grp;
      const int gy = y0 - 1 + r / HX, gx = x0 - 1 + r % HX;
      float2 ms = make_float2(0.f, 0.f);
      if (r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W) ms = stats[(long long)gy * W + gx];
      s[k] = ms.x;
      q[k] = ms.y;
    }
  } else {
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
        const float mu = s[k] * inv_c;
        q[k] = 0.f;
        if (valid)
#pragma unroll
          for (int e = 0; e < 8; ++e) q[k] += (f[e] - mu) * (f[e] - mu);
      }
#pragma unroll
      for (int o = LPP / 2; o; o >>= 1)
#pragma unroll
        for (int k = 0; k < ITER; ++k) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
    }
  }
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int r = k * GROUPS + grp;
    const int gy = y0 - 1 + r / HX, gx = x0 - 1 + r % HX;
    float f[8];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      unpack8(v[k], f);
      const float mu = STATS ? s[k] : s[k] * inv_c;
      if (EXACT) {
        const float rs = STATS ? q[k] : 1.f / sqrtf(q[k] * inv_c + kLnEps);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = __bfloat162float(__float2bfloat16((f[e] - mu) * rs * g8[e] + b8[e]));
          f[e] = __fdividef(y, 1.f + __expf(-y));
        }
      } else {
        const float rs = STATS ? q[k] : rsqrtf(fmaxf(q[k] * inv_c - mu * mu, 0.f) + kLnEps);
        const float nmr = -mu * rs;
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

// The forms of tail_kernel: all C = 64 KH channels in one launch (kFull:
// the released widths, no mask, the division by C a constant), C < 64 KH
// (kMasked), or a group of a launch per 128 channels (kGrouped: the row
// pass's statistics, the f32 accumulator).
enum TailMode { kFull = 0, kMasked = 1, kGrouped = 2 };

template <bool EXACT, int KH, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    tail_kernel(const __grid_constant__ CUtensorMap map_x, const TailArgs p) {
  constexpr int GC = 64 * KH;  // the group's channels, the last box's zero fill included
  constexpr bool STATS = MODE == kGrouped, MASK = MODE != kFull;
  const int C = MASK ? p.C : GC, c0 = STATS ? p.c0 : 0;
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
  // the group's weights, once, in the swizzled K-major layout of the B
  // operand; zeros for the channels past C
  for (int i = tid; i < 3 * BN * (GC / 8); i += THREADS) {
    const int row = i / (GC / 8), ch = i % (GC / 8);  // row = dy * BN + n
    const int dy = row / BN, n = row % BN, c = c0 + 8 * ch;
    *reinterpret_cast<uint4*>(wsm + (dy * KH + ch / 8) * WTILE + n * 128 +
                              (((ch & 7) ^ (n & 7)) << 4)) =
        c < C ? ld_u4(p.w + (long long)row * C + c) : make_uint4(0u, 0u, 0u, 0u);
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
          tma_5d(base + s * kStage + h * SLICE, &map_x, bar, c0 + 64 * h, x0 - 1, y0 - 1,
                 f0 + i, clip);
      }
    }
    return;
  }

  if (wid < ACT / 32) {
    // activators: LN + SiLU of each frame's box in place, up to S frames
    // ahead of the products
    float g8[8], b8[8];  // this thread's channels' norm scale and bias (fast: halved)
    const int c = c0 + 64 * ((tid % (8 * KH)) >> 3) + 8 * (tid & 7);
    const bool valid = !MASK || c < C;
    const float half = EXACT ? 1.f : 0.5f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g8[e] = valid ? half * p.g[c + e] : 0.f;
      b8[e] = valid ? half * p.b[c + e] : 0.f;
    }
    const long long hw = (long long)p.H * p.W;
    const float inv_c = 1.f / C;
    for (int i = 0; i < frames; ++i) {
      const int s = i % S;
      mbar_wait(full + 8 * s, (i / S) & 1);
      activate<EXACT, KH, STATS>(smem + s * kStage, tid, g8, b8, valid, y0, x0, p.H, p.W, inv_c,
                                 STATS ? p.stats + ((long long)clip * p.T + f0 + i) * hw
                                       : nullptr);
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
  const long long opos = ((long long)clip * p.T * hw + (long long)(y0 + oy) * p.W + (x0 + ox)) *
                         COUT;  // this position's output in frame 0
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
        const long long o = opos + (long long)f * hw * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          if constexpr (STATS) {
            tail_store(p.out, p.acc, o + co, o0[co], bias[co], p.first, p.last);
          } else {
            p.out[o + co] = __float2bfloat16(o0[co] + bias[co]);
          }
        }
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
// channels at a time (zero past C).
int tail_map(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C) {
  const unsigned long long dims[5] = {(unsigned long long)C, (unsigned long long)W,
                                      (unsigned long long)H, (unsigned long long)T,
                                      (unsigned long long)B};
  const unsigned box[5] = {64, HX, HY, 1, 1};
  return encode_map(map, x, 5, dims, box);
}

constexpr int GROUP = 128;  // channels a tail launch takes (plan.TAIL_GROUP)

template <bool EXACT>
int launch_tail(const void* x, void* stats, void* acc, void* out, const void* g, const void* b,
                const void* w, const void* bias, int B, int T, int H, int W, int C,
                int replicate, int th, int tw, int run, int stages, int smem, int grid,
                void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int groups = (C + GROUP - 1) / GROUP;
  const int kh = ((C < GROUP ? C : GROUP) + 63) / 64;
  if (C % 8 || C < 8 || C > 1024 || th != TH || tw != TW || B < 1 || T < 1 || H < 1 ||
      W < 1 || run < 1 || stages < 2 || smem < smem_bytes(kh, stages) ||
      (groups > 1 && (stats == nullptr || acc == nullptr)))
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
  p.C = C;
  p.stats = static_cast<const float2*>(stats);
  p.acc = static_cast<float*>(acc);
  if ((long long)B * p.tiles_x * p.tiles_y * p.runs != grid) return kErrTailPlan;
  CUtensorMap map;
  int e = tail_map(&map, x, B, T, H, W, C);
  if (e) return e;
  if (groups > 1) {
    const RowArgs r{x, p.g, p.b, stats};
    if ((e = launch_act_rows<false, kRowStatsBf16>(r, (long long)B * T * H * W, C, cs))) return e;
  }
  for (int gi = 0; gi < groups; ++gi) {
    p.c0 = gi * GROUP;
    p.first = gi == 0;
    p.last = gi == groups - 1;
    const int gkh = (C - p.c0 < GROUP ? C - p.c0 + 63 : GROUP + 63) / 64;
    const int mode = groups > 1 ? kGrouped : C == 64 * gkh ? kFull : kMasked;
    auto kernel = mode == kGrouped  ? (gkh == 2 ? tail_kernel<EXACT, 2, kGrouped>
                                                : tail_kernel<EXACT, 1, kGrouped>)
                  : mode == kMasked ? (gkh == 2 ? tail_kernel<EXACT, 2, kMasked>
                                                : tail_kernel<EXACT, 1, kMasked>)
                                    : (gkh == 2 ? tail_kernel<EXACT, 2, kFull>
                                                : tail_kernel<EXACT, 1, kFull>);
    const cudaError_t a =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return (int)a;
    kernel<<<grid, THREADS, smem, cs>>>(map, p);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

}  // namespace

// Kernel D: the fast LN+SiLU (ln_silu, common.cuh). Past 128 channels
// ``stats`` is a [B, T, H, W] float2 and ``acc`` a [B, T, H, W, 3] f32
// scratch (else null).
extern "C" int vt_decoder_tail_rgb(const void* x, void* stats, void* acc, void* out,
                                   const void* g, const void* b, const void* w,
                                   const void* bias, int B, int T, int H, int W, int C,
                                   int replicate, int th, int tw, int run, int stages, int smem,
                                   int grid, void* stream) {
  return launch_tail<false>(x, stats, acc, out, g, b, w, bias, B, T, H, W, C, replicate, th, tw,
                            run, stages, smem, grid, stream);
}

// Kernel D': the exact LN+SiLU of decoder_tail.py:42 _ln_silu.
extern "C" int vt_decoder_tail_rgb_taps(const void* x, void* stats, void* acc, void* out,
                                        const void* g, const void* b, const void* w,
                                        const void* bias, int B, int T, int H, int W, int C,
                                        int replicate, int th, int tw, int run, int stages,
                                        int smem, int grid, void* stream) {
  return launch_tail<true>(x, stats, acc, out, g, b, w, bias, B, T, H, W, C, replicate, th, tw,
                           run, stages, smem, grid, stream);
}

namespace {

// Kernel D's f32 form and D''s (see the header): a unit is one frame's
// KC-channel slice; its raw f32 box (RAW bytes) comes by TMA, its three
// bf16 pieces (PIECE bytes each, a PSTAGE) are written by the activating
// warpgroups and multiplied by the multiplying one.
constexpr int KC = 32;                    // channels of a slice: 128 B of f32
constexpr int RAW = HALO * KC * 4;        // 20 KB
constexpr int PIECE = HALO * KC * 2;      // 10 KB: rows of 64 B, 64-byte swizzle
constexpr int PSTAGE = kPieces * PIECE;   // 30 KB
constexpr int PSTAGES = 2;
constexpr int WTILE32 = BN * KC * 2;      // one (piece, dy, slice) weight tile

__host__ __device__ constexpr int smem_bytes_f32(int ks, int stages) {
  return 1024 + stages * RAW + PSTAGES * PSTAGE + kPieces * 3 * ks * WTILE32 + 2 * PBUF +
         16 * (stages + PSTAGES);
}

// The byte offset of 16-byte chunk ``chunk`` (of 4) of row ``row`` of a
// K-major tile of 64-byte rows under the 64-byte swizzle (the tile
// 512-aligned): the chunk XOR bits 1-2 of the row.
__device__ __forceinline__ int sw64(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// wgmma operand descriptor of such a tile: 8-row groups 512 B apart.
__device__ __forceinline__ uint64_t smem_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

struct TailF32Args {
  const float2* stats;        // [B, T, H, W] (mean, rstd), the row pass's
  const float* g;             // [C] norm scale
  const float* b;             // [C] norm bias
  const __nv_bfloat16* w;     // [3 pieces][3 dy][BN][C], row n = 9j + 3dx + co
  const float* bias;          // [3]
  float* out;                 // [B, T, H, W, 3]; the groups' accumulator too
  int T, H, W;
  int replicate;
  int tiles_x, tiles_y, run, runs, stages;
  int C, c0;                  // the channels; this group's first
  int first, last;            // this group is the first / the last
};

template <bool EXACT, int KS>
__global__ void __launch_bounds__(THREADS, 1)
    tail_f32_kernel(const __grid_constant__ CUtensorMap map_x, const TailF32Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int S = p.stages;
  const int o_piece = S * RAW, o_w = o_piece + PSTAGES * PSTAGE;
  const int o_pbuf = o_w + kPieces * 3 * KS * WTILE32;
  float* pbuf = reinterpret_cast<float*>(smem + o_pbuf);
  // raw stages: full (loaded), empty (read); piece stages: full (written),
  // empty (multiplied); bar + 8s
  const uint32_t full = base + o_pbuf + 2 * PBUF, empty = full + 8 * S;
  const uint32_t pfull = empty + 8 * S, pempty = pfull + 8 * PSTAGES;

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
      mbar_init(empty + 8 * s, ACT);  // every activating thread, after its fence
    }
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(pfull + 8 * s, ACT);  // every activating thread, after its fence
      mbar_init(pempty + 8 * s, 4);   // one arrival per multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the group's weight pieces, once, as B operand tiles [BN][KC] (64-byte
  // swizzle); zeros for the channels past C
  const int gv = KS * KC / 8;  // 16-byte vectors of a group's row
  for (int i = tid; i < kPieces * 3 * BN * gv; i += THREADS) {
    const int row = i / gv, ch = i % gv;  // row = (piece * 3 + dy) * BN + n
    const int tile = row / BN, n = row % BN, c = p.c0 + 8 * ch;
    *reinterpret_cast<uint4*>(smem + o_w + (tile * KS + ch / 4) * WTILE32 + sw64(n, ch & 3)) =
        c < p.C ? ld_u4(p.w + (long long)row * p.C + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int wid = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (wid >= PRODUCER / 32) {
    // producer: one thread issues every load, a unit at a time
    if (tid == PRODUCER) {
      prefetch_map(&map_x);
      for (int u = 0; u < frames * KS; ++u) {
        const int s = u % S;
        mbar_wait(empty + 8 * s, ((u / S) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, RAW);
        tma_5d(base + s * RAW, &map_x, full + 8 * s, p.c0 + KC * (u % KS), x0 - 1, y0 - 1,
               f0 + u / KS, clip);
      }
    }
    return;
  }

  if (wid < ACT / 32) {
    // activators: thread (r, qc) takes channels 8 qc .. 8 qc + 7 of each
    // slice of halo position r: LN from the row pass's statistics, SiLU,
    // zero outside the frame, the three pieces into the piece stage
    const int r = tid >> 2, qc = tid & 3;
    const int gy = y0 - 1 + r / HX, gx = x0 - 1 + r % HX;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const long long hw = (long long)p.H * p.W;
    const int c0 = (2 * qc) ^ (r & 7), c1 = (2 * qc + 1) ^ (r & 7);  // 128-byte swizzle
    const int pofs = o_piece + sw64(r, qc);
    for (int i = 0; i < frames; ++i) {
      float2 ms = make_float2(0.f, 0.f);
      if (inside) ms = p.stats[((long long)clip * p.T + f0 + i) * hw + (long long)gy * p.W + gx];
#pragma unroll 1
      for (int h = 0; h < KS; ++h) {
        const int u = i * KS + h, s = u % S, ps = u % PSTAGES;
        mbar_wait(full + 8 * s, (u / S) & 1);
        const unsigned char* row = smem + s * RAW + r * 128;
        const float4 a = *reinterpret_cast<const float4*>(row + (c0 << 4));
        const float4 b = *reinterpret_cast<const float4*>(row + (c1 << 4));
        float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        const int c = p.c0 + KC * h + 8 * qc;  // this thread's channels
        if (inside && c < p.C) {
          float g8[8], b8[8];
          ld8(p.g + c, g8);
          ld8(p.b + c, b8);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = EXACT ? ln_silu_exact_f32(f[e], ms.x, ms.y, g8[e], b8[e])
                         : ln_silu_f32(f[e], ms.x, ms.y, g8[e], b8[e]);
        } else {
          // the conv's SAME padding, after the activation; channels past C
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
        uint4 pieces[kPieces];
        split3(f, pieces);
        mbar_wait(pempty + 8 * ps, ((u / PSTAGES) & 1) ^ 1);  // the first round passes
#pragma unroll
        for (int k = 0; k < kPieces; ++k)
          *reinterpret_cast<uint4*>(smem + pofs + ps * PSTAGE + k * PIECE) = pieces[k];
        // the products read the pieces through the async proxy; the same fence
        // orders this thread's reads of the raw stage before TMA's next write
        // to it (released right after the reads, without it, the stage was
        // overwritten under them)
        fence_async_smem();
        mbar_arrive(pfull + 8 * ps);
        mbar_arrive(empty + 8 * s);
      }
    }
    return;
  }

  // the multiplying warpgroup: the six products of each slice, then the gather
  const int mt = tid - MMA, warp = mt >> 5, lane = mt & 31;
  const bool gatherer = mt < OUTS;
  const int oy = mt / TW, ox = mt % TW, m = oy * HX + ox;
  float bias[COUT], o0[COUT], o1[COUT], o2[COUT];  // the ring: outputs f, f+1, f+2
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    bias[co] = p.bias[co];
    o0[co] = o1[co] = o2[co] = 0.f;
  }
  const bool write_pos = gatherer && y0 + oy < p.H && x0 + ox < p.W;
  const long long hw = (long long)p.H * p.W;
  const long long opos = ((long long)clip * p.T * hw + (long long)(y0 + oy) * p.W + (x0 + ox)) *
                         COUT;  // this position's output in frame 0
  const uint32_t pa = base + o_piece, wb = base + o_w;

  for (int i = 0; i < frames; ++i) {
    const int f = f0 + i;
    float acc0[16], acc1[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc0[k] = acc1[k] = 0.f;
    fence_acc(acc0);
    fence_acc(acc1);
#pragma unroll 1
    for (int h = 0; h < KS; ++h) {
      const int u = i * KS + h, ps = u % PSTAGES;
      mbar_wait(pfull + 8 * ps, (u / PSTAGES) & 1);
      wgmma_fence();
      const uint32_t a = pa + ps * PSTAGE;
      // P[m, n] += sum_dy sum_c a_i[m + 16 dy, c] w_j[dy, n, c] over the
      // products (i, j), smallest first; rows 0-63 in acc0, 64-127 in acc1
#pragma unroll
      for (int prod = 0; prod < kProducts; ++prod) {
        const int ia = (kPieceA >> (4 * prod)) & 15, jw = (kPieceW >> (4 * prod)) & 15;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint64_t dw = smem_desc64(wb + ((jw * 3 + dy) * KS + h) * WTILE32 + 32 * k);
            const uint32_t ak = a + ia * PIECE + dy * HX * 64 + 32 * k;
            wgmma_n32(acc0, smem_desc64(ak), dw);
            wgmma_n32(acc1, smem_desc64(ak + 64 * 64), dw);
          }
      }
      wgmma_commit();
      if (h > 0) {  // the slice before is multiplied: its stage goes back
        wgmma_wait<1>();
        fence_acc(acc0);
        fence_acc(acc1);
        if (lane == 0) mbar_arrive(pempty + 8 * ((u - 1) % PSTAGES));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (lane == 0) mbar_arrive(pempty + 8 * (((i + 1) * KS - 1) % PSTAGES));

    // acc -> P, then the gather, as tail_kernel's
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
        const long long o = opos + (long long)f * hw * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co)
          tail_store(p.out, p.out, o + co, o0[co], bias[co], p.first, p.last);
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

// The map of f32 x [B, T, H, W, C] for loads of one frame's halo box, KC
// channels (128 B) at a time, 128-byte swizzle, zero fill outside.
int tail_map_f32(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t d[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T,
                           (cuuint64_t)B};
  const cuuint64_t strides[4] = {4ull * C, 4ull * C * W, 4ull * C * W * H,
                                 4ull * C * W * H * T};
  const cuuint32_t box[5] = {KC, HX, HY, 1, 1}, e[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x), d,
                        strides, box, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <bool EXACT>
int launch_tail_f32(const void* x, void* stats, void* out, const void* g, const void* b,
                    const void* w, const void* bias, int B, int T, int H, int W, int C,
                    int replicate, int th, int tw, int run, int stages, int smem, int grid,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (C + GROUP - 1) / GROUP;
  const int ks = ((C < GROUP ? C : GROUP) + KC - 1) / KC;
  if (C % 8 || C < 8 || C > 1024 || th != TH || tw != TW || B < 1 || T < 1 || H < 1 ||
      W < 1 || run < 1 || stages < 2 || smem < smem_bytes_f32(ks, stages))
    return kErrTailPlan;
  TailF32Args p{};
  p.stats = static_cast<const float2*>(stats);
  p.g = static_cast<const float*>(g);
  p.b = static_cast<const float*>(b);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.H = H;
  p.W = W;
  p.replicate = replicate;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  p.run = run;
  p.runs = (T + run - 1) / run;
  p.stages = stages;
  p.C = C;
  if ((long long)B * p.tiles_x * p.tiles_y * p.runs != grid) return kErrTailPlan;
  CUtensorMap map;
  int e = tail_map_f32(&map, x, B, T, H, W, C);
  if (e) return e;
  const RowArgs r{x, p.g, p.b, stats};
  if ((e = launch_act_rows<false, kRowStats>(r, (long long)B * T * H * W, C, s))) return e;
  for (int gi = 0; gi < groups; ++gi) {
    p.c0 = gi * GROUP;
    p.first = gi == 0;
    p.last = gi == groups - 1;
    // this group's slices, the last one zero-filled past C
    const int gks = ((C - p.c0 < GROUP ? C - p.c0 : GROUP) + KC - 1) / KC;
    auto kernel = gks == 4   ? tail_f32_kernel<EXACT, 4>
                  : gks == 3 ? tail_f32_kernel<EXACT, 3>
                  : gks == 2 ? tail_f32_kernel<EXACT, 2>
                             : tail_f32_kernel<EXACT, 1>;
    const cudaError_t a =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return (int)a;
    kernel<<<grid, THREADS, smem, s>>>(map, p);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

}  // namespace

// Kernels D and D' in f32: x f32 [B, T, H, W, C], stats a [B, T, H, W]
// float2 scratch, out f32 [B, T, H, W, 3]; w the bf16 pieces [3][3 dy][BN][C]
// of D's packed weight (ops/kernels/decoder_tail.py: tail_operands_f32); the
// plan (th, tw, run, stages, smem, grid) plan.py's tail_plan_f32.
extern "C" int vt_decoder_tail_rgb_f32(const void* x, void* stats, void* out, const void* g,
                                       const void* b, const void* w, const void* bias, int B,
                                       int T, int H, int W, int C, int replicate, int th,
                                       int tw, int run, int stages, int smem, int grid,
                                       void* stream) {
  return launch_tail_f32<false>(x, stats, out, g, b, w, bias, B, T, H, W, C, replicate, th,
                                tw, run, stages, smem, grid, stream);
}

extern "C" int vt_decoder_tail_rgb_taps_f32(const void* x, void* stats, void* out,
                                            const void* g, const void* b, const void* w,
                                            const void* bias, int B, int T, int H, int W,
                                            int C, int replicate, int th, int tw, int run,
                                            int stages, int smem, int grid, void* stream) {
  return launch_tail_f32<true>(x, stats, out, g, b, w, bias, B, T, H, W, C, replicate, th,
                               tw, run, stages, smem, grid, stream);
}
