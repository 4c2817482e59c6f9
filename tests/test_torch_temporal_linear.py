"""The v1.1 trilinear temporal upsample on the base convs of its input
frames (``ops/kernels/temporal_linear.py``): cuDNN's (1,3,3) conv with the
three time taps stacked and the blend kernel.

On the CPU: the chain the module ran before (``interp.temporal_linear_up2x``
of the head and tail, their ``cat``, the conv's front from
``pad_time_front`` or ``Stream.front``, the 3x3x3 conv of the doubled
frames, its bias added after it, the blend), spelled out here, against the
reference forms kept in the ops module (bit for bit in f32 and bf16) and
against ``TimeUpsampleRes2x`` with ``fused`` (the blend's plain form) in
every case the decoder reaches, with the caches it leaves;
:func:`temporal_linear_upsample` (the base convs and the blend's plain
form) against the chain at each front, split, length, width and
dtype, with the next chunk's front sums; and what the wrapper refuses.

On the card (marker ``card``; this file imports no JAX, so the card's
machine runs it alone: ``python3 -m pytest --noconftest
tests/test_torch_temporal_linear.py -m card``): the kernel against its plain
form on the same inputs, in f32 and bf16, at the tiled benchmark cell's two
upsample shapes and chunk lengths, at a width that is a multiple of 8 and
not a power of 2, and at widths that are not.
"""

import pytest
import torch

from vidtok_tpu_torch.modules import interp
from vidtok_tpu_torch.modules.blocks import TimeUpsampleRes2x
from vidtok_tpu_torch.modules.conv import conv3d_cl, pad_time_front
from vidtok_tpu_torch.modules.stream import Stream
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import temporal_linear as TL
from vidtok_tpu_torch.ops.kernels.temporal_linear import (linear_blend_plain,
                                                          temporal_linear_up2x_plain)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-5
BF16_SLACK = 1.1  # bf16: at most this times the chain's own bf16 distance
# case -> (ntu, first_pad_mode, chunk frames, None (no stream), "first" (a
# stream's first chunk) or a later chunk's cache offset)
CASES = {"ntu1": (1, "replicate", 5, None), "ntu2": (2, "replicate", 5, None),
         "t-is-ntu": (2, "replicate", 2, None), "zero-front": (2, "zero", 4, None),
         "first-chunk": (2, "replicate", 4, "first"), "later-off0": (2, "replicate", 3, 0),
         "later-off2": (2, "replicate", 5, 2), "later-off4": (2, "replicate", 3, 4)}
C = 16


def module(ntu, mode, off):
    m = TimeUpsampleRes2x(C, C, ntu, mode, cache_offset=off)
    m.conv.reset_params(torch.Generator().manual_seed(1))
    with torch.no_grad():
        m.mix_factor.fill_(0.3)
    return m


def clip(t, dtype, seed, c=C):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, t, 6, 5, c), generator=g).to(dtype)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def chain(m, x, stream):
    """The parent module's trilinear branch up to the conv's input: (up,
    the conv's fronted input), the caches written into ``stream``."""
    ntu = m.ntu
    if stream is not None and not stream.first_chunk:
        xc = torch.cat([stream.get(m).to(x.dtype), x], dim=1)
        stream.put(m, xc[:, -2 * ntu:-ntu].clone())
        up = interp.temporal_linear_up2x(xc)[:, 2 * ntu:]
    else:
        if stream is not None:
            stream.put(m, x[:, -ntu:].clone())
        up = interp.temporal_linear_up2x(x[:, :ntu])
        if x.shape[1] > ntu:
            up = torch.cat([up, interp.temporal_linear_up2x(x[:, ntu:])], dim=1)
    if stream is None:
        return up, pad_time_front(up, 2, m.first_pad_mode)
    return up, stream.front(m.conv, up, 2)


def fused_caches(m, plain):
    """The fused form's caches of a plain form's: the last of the cached
    input frames, and the front sums of the two cached front frames."""
    prev = plain[""][:, -1:]
    return {"": prev, "conv": TL.front_sums(plain["conv"], prev, m.conv.conv.weight.detach())}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_forms_equal_the_chain(case, dtype):
    """The chain's reference forms equal it bit for bit; the module with
    ``fused`` equals it in f32 within F32_REL and in bf16 within BF16_SLACK
    of the chain's own distance from its f32 answer, and leaves the caches
    its blend reads (those of the plain branch, convolved)."""
    ntu, mode, t, where = CASES[case]
    dt = DTYPES[dtype]
    off = where if isinstance(where, int) else 2
    m = module(ntu, mode, off)
    later = isinstance(where, int)

    def run(d):
        x = clip(t, d, 2)
        cache = fcache = None
        with torch.no_grad():
            if later:  # the previous chunk's caches, plain and fused
                s0 = Stream(m, None, True, use_cache_offset=True)
                m(clip(4, d, 3), stream=s0)
                cache = s0.new
                s1 = Stream(m, None, True, use_cache_offset=True)
                m(clip(4, d, 3), fused=True, stream=s1)
                fcache = s1.new

            def stream(c):
                return None if where is None else Stream(
                    m, c, where == "first", use_cache_offset=True)

            ref = stream(cache)
            up, full = chain(m, x, ref)
            w, bias = m.conv.conv.weight, m.conv.conv.bias
            y = conv3d_cl(full, w, None, (1, 1, 1), (0, 1, 1))
            alpha = torch.sigmoid(m.mix_factor).to(d)
            want = alpha * up + (1 - alpha) * (y + bias.to(d))
            fused = stream(fcache)
            K.reset_counts()
            out = m(x, fused=True, stream=fused)
        return x, cache, fcache, up, full, y, want, ref, fused, out

    x, cache, fcache, up, full, y, want, ref, fused, out = run(dt)
    prev = cache[""].to(dt) if later else None
    front = (cache["conv"].to(dt) if later
             else "replicate" if where == "first" else mode)
    got = temporal_linear_up2x_plain(x, 0 if later else ntu, prev, front)
    assert got.dtype == dt and torch.equal(got, full)
    alpha = torch.sigmoid(m.mix_factor).to(dt)
    assert torch.equal(linear_blend_plain(full, y, m.conv.conv.bias, alpha.float()), want)

    calls = K.counts("calls")
    assert calls["temporal_linear_blend"] == 1
    assert 2 * K.counts("base_frames")["temporal_linear_blend"] == \
        K.counts("up_frames")["temporal_linear_blend"] == 2 * t
    assert all(n == 0 for n in K.counts().values())  # CPU: no launches
    if dt == torch.float32:
        assert rel(out, want) <= F32_REL
    else:
        want32 = run(torch.float32)[6]
        assert rel(out, want32) <= BF16_SLACK * rel(want, want32)
    if where is not None:
        assert fused.new.keys() == ref.new.keys() == {"", "conv"}
        expect = fused_caches(m, ref.new)
        assert torch.equal(fused.new[""], expect[""])
        assert rel(fused.new["conv"], expect["conv"]) <= (F32_REL if dt == torch.float32
                                                          else 1e-2)
    if later:  # the first chunk's fused caches are the plain ones', convolved
        expect = fused_caches(m, cache)
        assert torch.equal(fcache[""], expect[""])
        assert rel(fcache["conv"], expect["conv"]) <= (F32_REL if dt == torch.float32
                                                       else 1e-2)


def test_plain_j_takes_one_frame_of_prev_and_any_split():
    """The interpolation reads only the last frame of ``prev``; a split past T is one
    segment; split 0 without ``prev`` clamps frame 0 to itself."""
    x = clip(4, torch.float32, 5)
    prev = clip(3, torch.float32, 6)
    a = temporal_linear_up2x_plain(x, 0, prev, "zero")
    b = temporal_linear_up2x_plain(x, 0, prev[:, -1:], "zero")
    assert torch.equal(a, b) and torch.equal(a[:, :2], torch.zeros_like(a[:, :2]))
    whole = interp.temporal_linear_up2x(x)
    assert torch.equal(temporal_linear_up2x_plain(x, 9, None, "replicate")[:, 2:], whole)
    assert torch.equal(temporal_linear_up2x_plain(x, 0, None, "replicate")[:, 2:], whole)


# -- the base convs and the blend against the chain ---------------------------

FRONT_CASES = {"replicate": ("replicate", False), "zero": ("zero", False),
               "cached": ("cached", False), "cached-prev": ("cached", True)}


def _taps(w, dt):
    return torch.cat(w.to(dt).unbind(2))[:, :, None]


def _upsample_case(front_case, split, t, c, dt):
    """(chain's output, chain's next front sums, the upsample's output and
    next sums), the next front rows 2T and 2T + 1 and predecessor T - 1."""
    mode, with_prev = FRONT_CASES[front_case]
    g = torch.Generator().manual_seed(31 * t + c + split)
    x = torch.randn((1, t, 5, 4, c), generator=g)
    w = torch.randn((c, c, 3, 3, 3), generator=g) / (27 * c) ** 0.5
    bias = 0.1 * torch.randn(c, generator=g)
    alpha = torch.sigmoid(torch.tensor([0.3]))
    prev = torch.randn((1, 1, 5, 4, c), generator=g) if with_prev else None
    frames = torch.randn((1, 2, 5, 4, c), generator=g) if mode == "cached" else None

    def chain_of(d):
        p = None if prev is None else prev.to(d)
        full = temporal_linear_up2x_plain(x.to(d), split, p,
                                          mode if frames is None else frames.to(d))
        y = conv3d_cl(full, w, None, (1, 1, 1), (0, 1, 1))
        out = linear_blend_plain(full, y, bias, alpha.to(d).float())
        return out, TL.front_sums(full[:, 2 * t:2 * t + 2], x[:, t - 1:t].to(d), w)

    taps = _taps(w, dt)
    p = None if prev is None else prev.to(dt)
    front = mode if frames is None else TL.front_sums(frames.to(dt), p, w.to(dt)).to(dt)
    out, sums = TL.temporal_linear_upsample(
        x.to(dt), lambda v: conv3d_cl(v, taps, None, (1, 1, 1), (0, 1, 1)), bias,
        alpha.to(dt).float(), split, p, front, (2 * t, t - 1))
    return chain_of(torch.float32), chain_of(dt), out, sums


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 24, 128])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("front", FRONT_CASES)
def test_upsample_equals_the_chain(front, split, t, c, dtype):
    """``temporal_linear_upsample`` (the base convs, the blend's plain form)
    against the chain ``linear_blend_plain(full, conv(full),
    bias, alpha)``, ``full = temporal_linear_up2x_plain(...)``, at each
    front (zero, replicate, cached frames with and without a predecessor),
    split, length, width and dtype; with the next chunk's front sums
    against those of the chain's ``full``. f32 within F32_REL; bf16 within
    BF16_SLACK of the chain's own bf16 distance from its f32 answer (the
    sums within 1e-2)."""
    dt = DTYPES[dtype]
    (want32, sums32), (want, _), out, sums = _upsample_case(front, split, t, c, dt)
    assert out.dtype == sums.dtype == dt
    if dt == torch.float32:
        assert rel(out, want32) <= F32_REL and rel(sums, sums32) <= F32_REL
    else:
        assert rel(out, want32) <= BF16_SLACK * rel(want, want32)
        assert rel(sums, sums32) <= 1e-2


def _refusals():
    x = torch.zeros((1, 3, 2, 2, 8))
    p = torch.zeros((1, 3, 2, 2, 24))
    sums = torch.zeros((1, 3, 2, 2, 8))
    one = torch.zeros((1, 1, 2, 2, 8))
    b, a = torch.zeros(8), torch.ones(1)
    return {
        "unknown front": ((x, p, b, a, 1, None, "reflect"), "unknown front"),
        "prev without sums": ((x, p, b, a, 0, one, "zero"), "predecessor"),
        "no frame": ((x[:, :0], p[:, :0], b, a, 1), "at least one frame"),
        "taps not 3C": ((x, p[..., :16], b, a, 1), "p shape"),
        "frames": ((x, p[:, :2], b, a, 1), "p shape"),
        "sums frames": ((x, p, b, a, 0, one, sums[:, :2]), "front shape"),
        "dtype": ((x, p.double(), b, a, 1), "p must be"),
        "prev frames": ((x, p, b, a, 0, torch.zeros((1, 2, 2, 2, 8)), sums), "prev shape"),
        "next past the chunk": ((x, p, b, a, 1, None, "zero", (7, 2)), "outside the chunk"),
        "next without prev": ((x, p, b, a, 1, None, "zero", (2, -1)), "predecessor"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses(case):
    """The blend refuses, on the CPU as on the card, an unknown front, no
    frame, shapes and dtypes that do not fit, and what it cannot compute (a
    predecessor without the sums that hold its share, a next front outside
    the chunk or a next predecessor that is not there)."""
    args, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        K.temporal_linear_blend(*args)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiled_cases():
    """(shape, ntu, later) at the tiled cell's decoder chunks (``[1,3,201,
    256²]`` clips, ``t_chunk_enc`` 16): n latents a chunk give (n, 128², 512)
    at ntu 1 and (2n, 256², 256) at ntu 2; each length once as a first
    chunk and once as a later one (cache offsets 2 and 4)."""
    from vtbench.reference.work import chunk_schedule

    _, dec = chunk_schedule(201)
    out = []
    for n in sorted(set(dec)):
        for later in (False, True):
            out += [((1, n, 128, 128, 512), 1, later), ((1, 2 * n, 256, 256, 256), 2, later)]
    return out


RAGGED = [((2, 5, 33, 33, c), ntu, later) for c in (200, 36, 37)
          for ntu, later in ((1, False), (2, False), (5, False), (2, True))]
CARD_CASES = _tiled_cases() + RAGGED


def _blend_args(shape, ntu, later, dt, device, seed):
    """The blend's arguments for one chunk of ``shape`` as the module gives
    them on a stream (a later chunk at cache offset 2 ntu), on drawn base
    convs, predecessor frame and front sums."""
    g = torch.Generator(device).manual_seed(seed)
    b, t, h, w, c = shape

    def draw(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=device)).to(dt)

    x = draw(b, t, h, w, c)
    p = draw(b, t, h, w, 3 * c, scale=0.5)
    bias = 0.1 * torch.randn(c, generator=g, device=device)
    alpha = torch.sigmoid(torch.tensor([2.0], device=device)).to(dt).float()
    nf = max(2 * t - 2 * ntu, 0)
    if later:
        return (x, p, bias, alpha, 0, draw(b, 1, h, w, c), draw(b, 3, h, w, c, scale=0.5),
                (nf, max(t - ntu - 1, -1)))
    return x, p, bias, alpha, min(ntu, t), None, "replicate", (nf, t - 1)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ntu,later", CARD_CASES)
def test_kernel_blend_on_card(card, shape, ntu, later, dtype):
    """The kernel against its plain form on the same inputs, the output and
    the next front sums: f32 within F32_REL; bf16 within the repo's bf16
    gate (``chip_smoke.KERNEL_GATE``, and BF16_SLACK x the plain bf16 form's
    own distance from the plain form in f32)."""
    dt = DTYPES[dtype]
    args = _blend_args(shape, ntu, later, dt, card, 13)
    K.reset_counts()
    got = K.temporal_linear_blend(*args)
    torch.cuda.synchronize()
    assert K.counts()["temporal_linear_blend"] == 1
    want = TL.temporal_linear_blend_plain(*args)
    want32 = TL.temporal_linear_blend_plain(*(
        a.float() if isinstance(a, torch.Tensor) and a.dtype == dt else a for a in args))
    for g, w, w32 in zip(got, want, want32, strict=True):
        assert g.shape == w.shape and g.dtype == dt
        if dt == torch.float32:
            assert rel(g, w) <= F32_REL
        else:
            r, plain_r = rel(g, w32), rel(w, w32)
            assert r <= 1e-2 and r <= BF16_SLACK * plain_r, (r, plain_r)
