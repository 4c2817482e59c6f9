"""Tile plans of the wgmma implicit-GEMM conv (``csrc/wgmma_conv.cuh``)
and of the decoder tail (``csrc/decoder_tail.cu``).

Kernels A, B, E and F launch that loop with a plan made here from the call's
shape, so the shapes stay where the CPU tests reach them: the patch of an
M tile, BN, the ring's stages, the shared memory and the grid. Kernels D
and D' launch the tail with :func:`tail_plan`'s patch, run of frames,
stages, shared memory and grid. Each C entry takes the plan as it is and
refuses one it cannot run. :func:`tile_origin` and :func:`tail_block`
mirror how a block finds its work from ``blockIdx.x``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

BM, BK = 128, 64                   # rows of an M tile; channels of a K step
PATCHES = ((8, 16), (4, 32))      # th x tw = BM
# the ring's stages: BN 256 one block per SM (192 KB of ring), BN 128 two
# (96 KB each: one block's epilogue overlaps the other's products)
STAGES = {128: 3, 256: 4}
BLOCKS_PER_SM = {128: 2, 256: 1}   # as wgmma_conv.cuh's kBlocksPerSM
SMEM_LIMIT = 232_448               # bytes of shared memory a block can use
SMEM_PER_SM = 233_472              # of an SM, 1 KB of it reserved per block
SMS = 132                          # streaming multiprocessors of an H100
GRID_LIMIT = 2 ** 31 - 1
# Channel counts the row pass (act_rows_kernel) takes: C / 8 lanes' worth
# of 16-byte vectors spread over at most a warp.
ROW_CHANNELS = (64, 128, 256, 512, 768, 1024)


@dataclass(frozen=True)
class ConvPlan:
    """One launch of the wgmma loop. ``th`` x ``tw`` is the patch of a
    spatial or parity M tile (temporal: 1 x BM rows of a clip); ``tiles_x``
    / ``tiles_y`` the patches across / down a frame (temporal: ``tiles_x``
    M tiles per clip, ``tiles_y`` 1); ``m_tiles`` all M tiles; ``n_tiles``
    = Cout / ``bn``; ``grid`` the blocks, one per (M tile, N tile)."""
    taps: str
    th: int
    tw: int
    tiles_x: int
    tiles_y: int
    m_tiles: int
    bn: int
    n_tiles: int
    stages: int
    smem: int
    grid: int


def stage_bytes(bn: int) -> int:
    return BM * BK * 2 + bn * BK * 2


def smem_bytes(bn: int, stages: int) -> int:
    """The ring, 1 KB to align it for the 128-byte swizzle, the barriers."""
    return 1024 + stages * stage_bytes(bn) + 16 * stages


def epilogue_bytes(bn: int) -> int:
    """The f32 tile the epilogue stages in the ring: BM rows of bn + 8."""
    return BM * (bn + 8) * 4


def _check_channels(cin: int, cout: int, cs: int = 0) -> None:
    if cin % BK or cs % BK:
        raise ValueError(f"the wgmma loop takes Cin % {BK} == 0, got Cin={cin}"
                         + (f", Cs={cs}" if cs else ""))
    if cout % 128:
        raise ValueError(f"the wgmma loop takes Cout % 128 == 0, got Cout={cout}")


def _plan(taps, th, tw, tiles_x, tiles_y, m_tiles, cout, unit=None) -> ConvPlan:
    # BN 256 reads each A tile once for two N tiles' worth of products, but
    # halves the blocks: take it only when the grid still fills the card.
    # BN divides ``unit`` (parity: C, so an N tile is one parity's columns).
    unit = cout if unit is None else unit
    bn = 256 if unit % 256 == 0 and m_tiles * (cout // 256) >= SMS else 128
    stages = STAGES[bn]
    plan = ConvPlan(taps, th, tw, tiles_x, tiles_y, m_tiles, bn, cout // bn,
                    stages, smem_bytes(bn, stages), m_tiles * (cout // bn))
    if (plan.smem > SMEM_LIMIT or stages * stage_bytes(bn) < epilogue_bytes(bn)
            or BLOCKS_PER_SM[bn] * (plan.smem + 1024) > SMEM_PER_SM):
        raise AssertionError(f"plan {plan} does not fit shared memory")
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"{plan.grid} blocks exceed the grid limit")
    return plan


def _patch(n: int, h: int, w: int) -> tuple:
    """(th, tw, tiles_x, tiles_y): the patch that covers an h x w frame with
    the fewest tiles, the first of PATCHES on a tie."""
    if min(n, h, w) < 1:
        raise ValueError(f"empty frames: {(n, h, w)}")
    th, tw = min(PATCHES, key=lambda p: -(-h // p[0]) * -(-w // p[1]))
    return th, tw, -(-w // tw), -(-h // th)


@functools.lru_cache(maxsize=None)
def conv_plan_spatial(n: int, h: int, w: int, cin: int, cout: int,
                      cs: int = 0) -> ConvPlan:
    """A 3x3 SAME conv of ``[n, h, w, cin]`` to ``cout`` channels (plus a
    1x1 term of ``cs`` channels), in ``_patch``'s patches."""
    _check_channels(cin, cout, cs)
    th, tw, tiles_x, tiles_y = _patch(n, h, w)
    return _plan("spatial", th, tw, tiles_x, tiles_y, n * tiles_x * tiles_y, cout)


@functools.lru_cache(maxsize=None)
def conv_plan_parity(b: int, t: int, h: int, w: int, c: int) -> ConvPlan:
    """Kernel E over ``[b, t, h, w, c]``: 18 taps of C channels (two frames
    x 3x3) to N = 2C columns, the even then the odd output frame, in
    ``_patch``'s patches of one frame; BN divides C, so C % 128 == 0."""
    if c % 128:
        raise ValueError(f"kernel E takes C % 128 == 0, got C={c}")
    th, tw, tiles_x, tiles_y = _patch(b * t, h, w)
    return _plan("parity", th, tw, tiles_x, tiles_y, b * t * tiles_x * tiles_y, 2 * c, c)


@functools.lru_cache(maxsize=None)
def conv_plan_temporal(b: int, t: int, s: int, c: int) -> ConvPlan:
    """A k=3 time conv of ``b`` clips of ``t`` output frames of ``s`` rows,
    C -> C, over a scratch of ``t + 2`` frames per clip."""
    _check_channels(c, c)
    if min(b, t, s) < 1:
        raise ValueError(f"empty clips: {(b, t, s)}")
    per_clip = -(-t * s // BM)
    return _plan("temporal", 1, BM, per_clip, 1, b * per_clip, c)


def tile_origin(plan: ConvPlan, block: int) -> tuple:
    """(M tile origin, first output column) of block ``block``, as the
    kernel decodes ``blockIdx.x``: spatial and parity ``(frame, y0, x0)``
    (parity: frame ``b * t + a`` of the input), temporal ``(clip, r0)``."""
    n0 = (block % plan.n_tiles) * plan.bn
    mt = block // plan.n_tiles
    if plan.taps != "temporal":
        q, tx = divmod(mt, plan.tiles_x)
        img, ty = divmod(q, plan.tiles_y)
        return (img, ty * plan.th, tx * plan.tw), n0
    clip, t = divmod(mt, plan.tiles_x)
    return (clip, t * BM), n0


def check_row_channels(c: int) -> None:
    if c not in ROW_CHANNELS:
        raise ValueError(f"the LN+SiLU row pass takes C in {ROW_CHANNELS}, got C={c}")


# The decoder tail (kernels D and D'). A block walks the frames of one
# TAIL_TH x TAIL_TW output patch of one clip; each input frame's halo box,
# (TAIL_TH + 2) x (TAIL_TW + 2) positions (16 wide, so a dy shift of the
# GEMM's A rows is 16 rows of 128 B, a whole number of swizzle atoms), is
# loaded once per 64 channels, activated once, and multiplied once per dy
# by [C, TAIL_BN] weights: 27 (time tap, dx, out channel) columns padded to
# TAIL_BN. A run that starts at frame t0 > 0 first takes TAIL_WARMUP
# frames before it.
TAIL_TH, TAIL_TW = 8, 14
TAIL_HALO = (TAIL_TH + 2) * (TAIL_TW + 2)      # positions of a halo box
TAIL_M = TAIL_TH * (TAIL_TW + 2)               # GEMM rows: two m64 tiles
TAIL_COLS, TAIL_BN = 27, 32
TAIL_CHANNELS = (64, 128)                     # C / 64 boxes of 128 B a position
TAIL_WARMUP = 2
TAIL_MAX_STAGES = 4
TAIL_BLOCKS_PER_SM = 1


@dataclass(frozen=True)
class TailPlan:
    """One launch of the decoder tail: ``tiles_x`` x ``tiles_y`` patches of
    ``th`` x ``tw`` per frame, each clip's frames cut into ``runs`` runs of
    ``run`` frames (the last may be shorter); ``grid`` blocks, one per
    (patch, clip, run); ``stages`` halo boxes in flight; ``smem`` bytes."""
    th: int
    tw: int
    tiles_x: int
    tiles_y: int
    run: int
    runs: int
    stages: int
    smem: int
    grid: int


def tail_stage_bytes(c: int) -> int:
    """One frame's halo box: C / 64 channel slices of TAIL_HALO rows of 128 B."""
    return (c // 64) * TAIL_HALO * 128


def tail_smem_bytes(c: int, stages: int) -> int:
    """1 KB to align the swizzled boxes, the ring of halo boxes, the
    weights (3 dy x C / 64 tiles of TAIL_BN rows of 128 B), two f32 partial
    buffers [TAIL_M, TAIL_COLS], the full, activated and empty barriers of
    each stage."""
    return (1024 + stages * tail_stage_bytes(c) + 3 * (c // 64) * TAIL_BN * 128
            + 2 * TAIL_M * TAIL_COLS * 4 + 24 * stages)


@functools.lru_cache(maxsize=None)
def tail_plan(b: int, t: int, h: int, w: int, c: int) -> TailPlan:
    """Kernels D and D' over ``[b, t, h, w, c]``. The run is the one that
    finishes first if every block takes as long as its frames, warm-up
    included, and blocks go out in waves of SMS x TAIL_BLOCKS_PER_SM; the
    longest such run on a tie (fewer warm-up frames)."""
    if min(b, t, h, w) < 1:
        raise ValueError(f"empty clips: {(b, t, h, w)}")
    if c % 16:
        raise ValueError(f"the decoder tail takes C % 16 == 0, got C={c}")
    if c not in TAIL_CHANNELS:
        raise ValueError(f"the decoder tail takes C in {TAIL_CHANNELS}, got C={c}")
    tiles_x, tiles_y = -(-w // TAIL_TW), -(-h // TAIL_TH)
    patches = b * tiles_x * tiles_y
    best = None
    for run in range(t, 0, -1):
        runs = -(-t // run)
        waves = -(-patches * runs // (SMS * TAIL_BLOCKS_PER_SM))
        cost = waves * (run + (TAIL_WARMUP if runs > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, run, runs)
    _, run, runs = best
    fixed = tail_smem_bytes(c, 0)
    stages = min(TAIL_MAX_STAGES, (SMEM_LIMIT - fixed) // (tail_stage_bytes(c) + 24))
    plan = TailPlan(TAIL_TH, TAIL_TW, tiles_x, tiles_y, run, runs, stages,
                    tail_smem_bytes(c, stages), patches * runs)
    if stages < 2 or plan.smem > SMEM_LIMIT:
        raise AssertionError(f"plan {plan} does not fit shared memory")
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"{plan.grid} blocks exceed the grid limit")
    return plan


def tail_block(plan: TailPlan, block: int, t: int) -> tuple:
    """(clip, y0, x0, t0, t1, first frame read) of block ``block``, as the
    kernel decodes ``blockIdx.x``: it writes output frames [t0, t1) of its
    patch and reads input frames from max(t0 - TAIL_WARMUP, 0)."""
    q, tx = divmod(block, plan.tiles_x)
    q, ty = divmod(q, plan.tiles_y)
    clip, r = divmod(q, plan.runs)
    t0 = r * plan.run
    return (clip, ty * plan.th, tx * plan.tw, t0, min(t, t0 + plan.run),
            max(t0 - TAIL_WARMUP, 0))
