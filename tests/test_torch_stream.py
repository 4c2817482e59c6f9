"""Tiled (streaming) inference of the PyTorch port against ``vidtok_tpu``.

* Kernel F: the plain version beside the CUDA kernel against
  ``fused_temporal_resblock_stream`` (Pallas, interpret mode) chunk by
  chunk, outputs and both caches; the port's ``ResnetBlockTemporal`` on a
  stream (``fused`` on and off) against JAX's unfused streaming block.
* The streaming ``CausalConv3d``, ``TimeDownsampleRes2x`` and trilinear
  ``TimeUpsampleRes2x`` against their JAX modules over 3 chunks, outputs
  and caches; a tiny v1.1 decoder streamed with overlap offsets.
* The engine (``VideoTokenizer`` with ``use_tiling``) on the tiny v1.1
  model of ``tests/test_torch_model.py`` against JAX's tiled engine, for
  ``use_overlap`` False and True; batched streams, the chunk size, the
  scan entry points, FSQ indices, and the v1.0 refusal.

Inputs and parameters come from numpy seeds; fp32, rtol 1e-4, atol 2e-4
(the repo's golden bound) unless a test says otherwise. On CPU tensors the
kernel wrappers run their plain versions and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidtok_tpu.modules.blocks as JB
import vidtok_tpu.modules.conv as JC
from vidtok_tpu.models.autoencoder import VideoTokenizer as JTok
from vidtok_tpu.models.autoencoder import build_core_from_config as j_build
from vidtok_tpu.modules.decoder import Decoder as JDecoder
from vidtok_tpu.ops.pallas.fused_temporal import \
    fused_temporal_resblock_stream as j_stream
from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.modules import conv as TC
from vidtok_tpu_torch.modules.decoder import Decoder
from vidtok_tpu_torch.modules.stream import Stream
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels.fused_temporal import (
    fused_temporal_resblock_stream, fused_temporal_resblock_stream_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-4)

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "interpolation_mode": "trilinear", "tempo_ds": [0], "tempo_us": [1]}


def _cfg(enc, dec, params, reg=None):
    return {"params": {
        "encoder_config": {"target": enc, "params": dict(params)},
        "decoder_config": {"target": dec, "params": dict(params)},
        "regularizer_config": reg or {"target": "DiagonalGaussianRegularizer"}}}


CFG = _cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1", _P)
FSQ_CFG = _cfg("EncoderCausal3DV1_1", "DecoderCausal3DV1_1",
               dict(_P, double_z=False, z_channels=6),
               {"target": "FSQRegularizer",
                "params": {"levels": [8, 8, 8, 5, 5, 5]}})


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.1)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_port(module, params, path, prefix):
    """Load a JAX parameter tree into ``module`` through
    ``state_dict_from_jax``, the tree placed at ``path`` of the model."""
    tree = params
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def jax_stream(mod, params, chunks, use_off=False, **kw):
    """Run a JAX module chunk by chunk: (outputs along time, last cache)."""
    outs, cache = [], {}
    for i, x in enumerate(chunks):
        var = {"params": params}
        if i:
            var["cache"] = cache
        y, vs = mod.apply(var, jnp.asarray(x), streaming=True,
                          first_chunk=i == 0, use_cache_offset=use_off,
                          mutable=["cache"], **kw)
        cache = vs["cache"]
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1), cache


def port_stream(module, chunks, use_off=False, **kw):
    """Run a port module chunk by chunk through explicit caches."""
    outs, cache = [], None
    with torch.no_grad():
        for i, x in enumerate(chunks):
            s = Stream(module, cache, first_chunk=i == 0, use_cache_offset=use_off)
            outs.append(module(t(x), stream=s, **kw))
            cache = s.new
    return torch.cat(outs, dim=1), cache


def close_caches(port, jcache):
    """A JAX cache collection of one module (``tpad``, ``pool`` or
    ``interp`` leaves, at the module or under a submodule) against the
    port's ``{module path: tensor}``."""
    want = {".".join(str(k.key) for k in path[:-1]): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jcache)}
    assert port.keys() == want.keys()
    for k in want:
        close(port[k], want[k])


def chunks_of(rng, lengths, *shape):
    return [(rng.randn(shape[0], n, *shape[1:]) * 0.5).astype(np.float32)
            for n in lengths]


# -- kernel F and the streaming modules -----------------------------------

@pytest.mark.parametrize("off,use_off", [(0, False), (1, True), (2, True),
                                         (4, True)])
def test_kernel_f_stream(off, use_off):
    """3 chunks at B=2, H=8, W=16, C=128, randomized norm scales and
    biases: F's plain version against the Pallas kernel (interpret) per
    chunk, y and both new caches; the port's block on a stream, kernel
    call site on and off, against JAX's unfused streaming block."""
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 8, 16, 128
    n = max(1, off)
    chunks = chunks_of(rng, (n, 4 * n, 4 * n), b, h, w, c)
    jm = JB.ResnetBlockTemporal(c, causal=True, norm_type="layernorm",
                                first_pad_mode="replicate", cache_offset=off)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"],
                  rng)
    want, jcache = jax_stream(jm, p, chunks, use_off, fused=False)

    tm = load_port(TB.ResnetBlockTemporal(c, c, first_pad_mode="replicate",
                                          cache_offset=off),
                   p, ("decoder", "up_temporal_1_block_0"),
                   "decoder.up_temporal.1.block.0.")
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias),
            (tm.conv1.conv.weight, tm.conv1.conv.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias),
            (tm.conv2.conv.weight, tm.conv2.conv.bias))
    offset = off if use_off else 0
    jc1 = jc2 = jnp.zeros((b, 2, h, w, c), jnp.float32)
    c1 = c2 = None
    with torch.no_grad():
        for i, x in enumerate(chunks):
            jy, jc1, jc2 = j_stream(jnp.asarray(x), p, jc1, jc2, first_chunk=i == 0,
                                    offset=offset, interpret=True)
            y, c1, c2 = fused_temporal_resblock_stream_plain(
                t(x), *args, c1, c2, i == 0, offset)
            for got, ref in ((y, jy), (c1, jc1), (c2, jc2)):
                close(got, ref)

    for fused in (False, True):
        K.reset_counts()
        got, cache = port_stream(tm, chunks, use_off, fused=fused)
        calls = K.counts("calls")
        assert calls["fused_temporal_resblock_stream"] == (3 if fused else 0)
        assert calls["fused_temporal_resblock"] == 0
        assert all(v == 0 for v in K.counts().values())  # CPU: no launches
        close(got, want)
        close_caches(cache, jcache)


def test_kernel_f_refuses_offset_past_chunk():
    """JAX falls back to its unfused path when t < offset; the port raises,
    since the new cache would reach into the previous chunk."""
    x = torch.zeros(1, 1, 2, 2, 8)
    norm = (torch.ones(8), torch.zeros(8))
    conv = (torch.zeros(8, 8, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="offset 2"):
        fused_temporal_resblock_stream(x, norm, conv, norm, conv, None, None,
                                       True, 2)


@pytest.mark.parametrize("stride,off", [(1, 0), (1, 2), (2, 0)])
def test_causal_conv3d_stream(stride, off):
    """The first chunk repeats frame 0 whatever ``first_pad_mode`` says
    (zero here); the cache is ``full[L-off-pad : L-off]``."""
    rng = np.random.RandomState(1)
    chunks = chunks_of(rng, (4, 4, 4), 1, 5, 6, 8)
    jm = JC.CausalConv3d(12, (3, 3, 3), stride=(stride, 1, 1),
                         first_pad_mode="zero", cache_offset=off)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"],
                  rng)
    want, jcache = jax_stream(jm, p, chunks, use_off=off > 0)
    tm = load_port(TC.CausalConv3d(8, 12, 3, (stride, 1, 1), first_pad_mode="zero",
                                   cache_offset=off),
                   p, ("encoder", "conv_in"), "encoder.conv_in.")
    got, cache = port_stream(tm, chunks, use_off=off > 0)
    close(got, want)
    close_caches(cache, jcache)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_time_downsample_stream(mode):
    """The pool's front: ``first_pad_mode`` on the first chunk, then the
    last frame of the previous ``[front | x]`` (no offset)."""
    rng = np.random.RandomState(2)
    chunks = chunks_of(rng, (2, 4, 4), 1, 3, 4, 8)
    jm = JB.TimeDownsampleRes2x(8, first_pad_mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"],
                  rng)
    want, jcache = jax_stream(jm, p, chunks)
    tm = load_port(TB.TimeDownsampleRes2x(8, 8, first_pad_mode=mode), p,
                   ("encoder", "down_temporal_1_downsample"),
                   "encoder.down_temporal.1.downsample.")
    got, cache = port_stream(tm, chunks)
    close(got, want)
    close_caches(cache, jcache)


@pytest.mark.parametrize("ntu,off", [(1, 0), (1, 2), (2, 0), (2, 2)])
def test_time_upsample_trilinear_stream(ntu, off):
    """The first chunk caches its last ntu frames; a later chunk caches
    ``[cache | x][-2ntu:-ntu]`` and drops its first 2ntu output frames; the
    conv's cache is stored ``off`` frames back. Plain, and with ``fused``
    through kernels J and K's plain forms."""
    rng = np.random.RandomState(3)
    chunks = chunks_of(rng, (ntu + 1, 3, 3), 1, 3, 4, 8)
    jm = JB.TimeUpsampleRes2x(8, interpolation_mode="trilinear",
                              num_temp_upsample=ntu, first_pad_mode="replicate",
                              cache_offset=off)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"],
                  rng)
    want, jcache = jax_stream(jm, p, chunks, use_off=off > 0)
    tm = load_port(TB.TimeUpsampleRes2x(8, 8, ntu, "replicate", cache_offset=off),
                   p, ("decoder", "up_temporal_1_upsample"),
                   "decoder.up_temporal.1.upsample.")
    for fused in (False, True):
        got, cache = port_stream(tm, chunks, use_off=off > 0, fused=fused)
        close(got, want)
        close_caches(cache, jcache)


def test_decoder_stream_overlap_offsets():
    """The tiny decoder of ``test_streaming_decoder_tail`` (ch 16, ch_mult
    (1,2,2,4), trilinear: the port's nearest upsample has no streaming form)
    streamed with cache offsets, the port's kernel call sites on and off,
    against JAX's streamed decoder, fused and unfused. The stage offsets
    are 1, 1, 2, 4 and the tail's 4 (``decoder.py:80-98``)."""
    rng = np.random.RandomState(4)
    kw = dict(ch=16, ch_mult=(1, 2, 2, 4), num_res_blocks=1, z_channels=8,
              out_ch=3, norm_type="layernorm", variant="causal_v1_1",
              interpolation_mode="trilinear")
    jd = JDecoder(**kw)
    chunks = chunks_of(rng, (1, 2, 2), 1, 4, 4, 8)
    p = randomize(jd.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"],
                  rng)
    td = load_port(Decoder(**kw), p, ("decoder",), "decoder.")
    assert td.stage_offsets(4) == (1, {3: 1, 2: 1, 1: 2, 0: 4},
                                   {2: 2, 1: 4}, 4)
    wants = [jax_stream(jd, p, chunks, use_off=True, fused=f)[0]
             for f in (False, True)]
    close(wants[1], wants[0])
    for fused in (False, True):
        K.reset_counts()
        got, _ = port_stream(td, chunks, use_off=True, fused=fused)
        assert K.counts("calls")["decoder_tail_rgb"] == (3 if fused else 0)
        assert got.shape == (1, 20, 32, 32, 3)
        close(got, wants[0])


# -- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX core and meta of ``CFG`` with random parameters, and a
    [1, 3, 9, 16, 16] clip (9 = 1 + 2 chunks of 4)."""
    core, meta = j_build(CFG)
    rng = np.random.RandomState(0)
    x = np.clip(rng.randn(1, 3, 9, 16, 16) * 0.5, -1, 1).astype(np.float32)
    v = core.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False)
    return core, meta, randomize(v["params"], rng), x


def port_tok(params, cfg=CFG, fused=False, **attrs):
    """The port's engine on the CPU with JAX's parameters, tiled with
    ``t_chunk_enc=4`` unless ``attrs`` say otherwise."""
    tok = load_model_from_config({"model": cfg}, device="cpu", fused=fused)
    load_port(tok.core, params, (), "")
    tok.use_tiling = True
    tok.t_chunk_enc, tok.t_chunk_dec = 4, 4 // tok.time_downsample_factor
    for k, v in attrs.items():
        setattr(tok, k, v)
    return tok


def jax_tok(core, meta, params, use_overlap):
    tok = JTok(core, params, dict(meta, use_tiling=True, t_chunk_enc=4), fused=False)
    tok.use_overlap = use_overlap
    return tok


@pytest.fixture(scope="module")
def jax_tiled(tiny):
    """JAX's tiled encode (z, reg_log), decode and forward of the tiny
    clip, for ``use_overlap`` False and True."""
    core, meta, params, x = tiny
    out = {}
    for use_overlap in (False, True):
        jt = jax_tok(core, meta, params, use_overlap)
        jz, jlog = jt.encode(jnp.asarray(x), return_reg_log=True)
        out[use_overlap] = (jz, jlog, jt.decode(jz), jt(jnp.asarray(x)))
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("use_overlap", [False, True])
def test_tiled_engine_vs_jax(tiny, jax_tiled, use_overlap, fused):
    """Tiled encode, decode and forward against JAX's ``_tile_encode`` and
    ``_tile_decode``; z against the port's own non-tiled encode (the
    encoder is causal). The kernel call sites run once per block per
    chunk: F for every temporal block, B never."""
    _, _, params, x = tiny
    jz, jlog, jdec, (jz2, jrec, _) = jax_tiled[use_overlap]
    tok = port_tok(params, fused=fused, use_overlap=use_overlap)
    K.reset_counts()
    z, log = tok.encode(x, return_reg_log=True)
    dec = tok.decode(z)
    calls = K.counts("calls")
    close(z, jz)
    close(log["kl_loss"], jlog["kl_loss"])
    close(dec, jdec)
    assert dec.shape == (1, 3, 10, 16, 16)

    enc_chunks = len(tok.build_chunk_start_end(x.shape[2]))
    dec_chunks = len(tok.build_chunk_start_end(z.shape[2], decoder_mode=True))
    assert (enc_chunks, dec_chunks) == (3, 3)
    # per chunk: 2 temporal (and spatial) blocks in the encoder, 4 in the
    # decoder; one spatial upsample and one tail per decoder chunk
    # and one trilinear temporal upsample, J and K
    want = dict.fromkeys(K.WRAPPERS, 0)
    if fused:
        want.update(fused_temporal_resblock_stream=2 * enc_chunks + 4 * dec_chunks,
                    fused_spatial_resblock=2 * enc_chunks + 4 * dec_chunks,
                    subpixel_interleave=dec_chunks, decoder_tail_rgb=dec_chunks,
                    temporal_linear_up2x=dec_chunks, linear_blend=dec_chunks)
    assert calls == want
    assert all(v == 0 for v in K.counts().values())

    tok.use_tiling = False
    close(tok.encode(x), jz)
    tok.use_tiling = True
    z2, rec, log2 = tok(x)
    close(z2, jz2)
    close(rec, jrec)
    assert rec.shape == x.shape
    close(log2["kl_loss"], log["kl_loss"])


def test_batched_streams_match_single_streams(tiny):
    """S=3 streams batched through one chunk step equal 3 single streams:
    each cache entry carries one row per stream."""
    _, _, params, _ = tiny
    x = (np.random.RandomState(5).randn(3, 3, 9, 16, 16) * 0.5).astype(np.float32)
    tok = port_tok(params, use_overlap=True)
    zb = tok.encode(x)
    z1 = [tok.encode(x[i:i + 1]) for i in range(3)]
    close(zb, torch.cat(z1))
    close(tok.decode(zb), torch.cat([tok.decode(z) for z in z1]))


def test_chunk_size_is_a_serving_knob(tiny):
    """``t_chunk_enc`` 4 and 8 give the same tokens and reconstruction."""
    _, _, params, _ = tiny
    x = (np.random.RandomState(6).randn(1, 3, 17, 16, 16) * 0.5).astype(np.float32)
    outs = []
    for tc in (4, 8):
        tok = port_tok(params, use_overlap=True, t_chunk_enc=tc, t_chunk_dec=tc // 2)
        z = tok.encode(x)
        outs.append((z, tok.decode(z)))
    close(outs[1][0], outs[0][0])
    close(outs[1][1], outs[0][1])


def test_streaming_scan_entry_points(tiny):
    """``encode_streaming_scan`` and ``decode_streaming_scan`` equal the
    tiled loop and keep JAX's alignment checks."""
    _, _, params, x = tiny
    tok = port_tok(params, use_overlap=True)
    z, log = tok.encode(x, return_reg_log=True)
    zs, logs = tok.encode_streaming_scan(x)
    close(zs, z)
    close(logs["kl_loss"], log["kl_loss"])
    close(tok.decode_streaming_scan(z), tok.decode(z))
    with pytest.raises(ValueError, match="T=8 not 1"):
        tok.encode_streaming_scan(x[:, :, :8])
    with pytest.raises(ValueError, match="T'=4 not 1"):
        tok.decode_streaming_scan(z[:, :, :4])


def test_tiled_fsq_matches_jax():
    """Tiled FSQ (``tests/test_streaming_fsq.py``'s config): indices equal
    to JAX's, and so is decoding from them."""
    core, meta = j_build(FSQ_CFG)
    rng = np.random.RandomState(7)
    x = (rng.randn(1, 3, 9, 16, 16) * 0.5).astype(np.float32)
    v = core.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)), sample_override=False)
    params = randomize(v["params"], rng)
    jt = jax_tok(core, meta, params, use_overlap=True)
    jz, jlog = jt.encode(jnp.asarray(x), return_reg_log=True)
    tok = port_tok(params, FSQ_CFG, use_overlap=True)
    z, log = tok.encode(x, return_reg_log=True)
    np.testing.assert_array_equal(log["indices"].numpy(), np.asarray(jlog["indices"]))
    close(z, jz)
    close(log["aux_loss"], jlog["aux_loss"])
    close(tok.decode(log["indices"], decode_from_indices=True),
          jt.decode(jlog["indices"], decode_from_indices=True))


def test_v1_0_refuses_tiling():
    """The v1.0 decoder crops warm-up frames per call, so chunks do not
    stitch: the port raises as JAX does."""
    v1_0 = _cfg("EncoderCausal3D", "DecoderCausal3D", _P)
    core, meta = j_build(v1_0)
    x = np.zeros((1, 3, 5, 16, 16), np.float32)
    jt = JTok(core, None, dict(meta, use_tiling=True), fused=False)
    with pytest.raises(ValueError, match="requires a v1.1 model"):
        jt.encode(jnp.asarray(x))
    tok = load_model_from_config({"model": v1_0}, device="cpu")
    tok.use_tiling = True
    with pytest.raises(ValueError, match="requires a v1.1 model"):
        tok.encode(x)
