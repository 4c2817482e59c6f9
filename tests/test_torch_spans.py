"""The port's spans and its operand-rebuild counter on the CPU, and the
benchmark's reader of them (``vtbench/spans.py`` and the ``program_span``
and ``program_counter`` metrics of ``vtbench/metrics``).

* With no profiler recording, a ch-32 forward makes no profiler range
  (``RecordFunction``); the same forward under a profiler makes them.
* Under a CPU profiler, ``forward``, a tiled forward and ``encode_chunk``
  of a tiny v1.1 model (ch 32, ``fused`` on: the wrappers run their plain
  forms) write the named spans, nested engine > model > stream cache or
  kernel; a tiled forward has one ``vt.engine.enc_chunk`` a chunk of
  ``build_chunk_start_end`` and one ``vt.engine.dec_chunk`` a latent
  chunk; the training forward spans its encoder and decoder too.
* ``builds`` counts one operand relayout per parameter and kind, none on a
  repeated call, one again after ``load_state_dict``; ``reset_counts``
  zeroes it.
* ``vtbench/spans.py`` on a synthetic trace joins device operations to
  their launches through ``args.correlation`` and attributes them to every
  enclosing span; an operation with no launch on the window's thread, or
  launched outside every span, stays unattributed.
* Every new metric reads the synthetic trace's numbers, and returns None
  on a trace without ``vt.*`` spans or a program without the counter.
* VidTwin (tiny, on the CPU) makes no profiler range with nothing
  recording; under a CPU profiler its forward writes the engine, encoder,
  decoder, attention, structure, Q-Former, dynamics and regularizer spans,
  nested engine > model > attention or structure > Q-Former; the readers
  of its spans read a synthetic VidTwin trace and nothing without spans.
"""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vidtok_tpu_torch import load_model_from_config
from vidtok_tpu_torch.modules.blocks import ResnetBlockTemporal
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import _lib
from vidtok_tpu_torch.ops.kernels.fused_temporal import block_operands
from vidtok_tpu_torch.utils import profiling as P
from vtbench import harness, spans
from vtbench.reference import vidtwin as VR
from vtbench.trace import WINDOW

torch.set_num_threads(2)

_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "interpolation_mode": "trilinear", "tempo_ds": [0], "tempo_us": [1]}
CFG = {"model": {"params": {
    "encoder_config": {"target": "EncoderCausal3DV1_1", "params": _P},
    "decoder_config": {"target": "DecoderCausal3DV1_1", "params": _P},
    "regularizer_config": {"target": "DiagonalGaussianRegularizer"}}}}
CLIP = (1, 3, 9, 16, 16)  # frame 0, then two chunks of 4


@pytest.fixture(scope="module")
def tok():
    t = load_model_from_config(CFG, device="cpu", fused=True)
    t.t_chunk_enc, t.t_chunk_dec = 4, 2
    return t


def clip():
    return torch.rand(CLIP, generator=torch.Generator().manual_seed(0)) * 2 - 1


def traced(tmp_path, fn) -> spans.Spans:
    """The spans ``fn()`` records under a CPU profiler, read back from the
    Chrome trace as the benchmark reads its traced window."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return spans.read(path)


def names(s: spans.Spans) -> list:
    return [p.name for p in s.spans]


def ancestors(s: spans.Spans, i: int) -> list:
    out = []
    while s.spans[i].parent is not None:
        i = s.spans[i].parent
        out.append(s.spans[i].name)
    return out


def check_nesting(s: spans.Spans, root: str) -> None:
    """One root span, every model span under an engine span, every stream
    cache and kernel span under a model span."""
    roots = [p.name for p in s.spans if p.parent is None]
    assert roots == [root]
    for i, p in enumerate(s.spans):
        up = ancestors(s, i)
        if p.name.startswith("vt.model."):
            assert any(a.startswith("vt.engine.") for a in up), (p.name, up)
        if p.name.startswith(("vt.kernel.", "vt.stream.")):
            assert any(a.startswith("vt.model.") for a in up), (p.name, up)
        if p.name.startswith("vt.model.down."):
            assert up[0] == "vt.model.encoder"
        if p.name.startswith("vt.model.up."):
            assert up[0] == "vt.model.decoder"


def test_no_range_while_nothing_records(tok, monkeypatch, tmp_path):
    made = []
    real = P._RANGE

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(P, "_RANGE", counted)
    x = clip()
    tok(x)
    assert made == []
    traced(tmp_path, lambda: tok(x))
    assert "vt.engine.forward" in made and "vt.model.encoder" in made


def test_forward_spans(tok, tmp_path):
    calls = sum(K.counts("calls").values())
    s = traced(tmp_path, lambda: tok(clip()))
    calls = sum(K.counts("calls").values()) - calls
    got = names(s)
    check_nesting(s, "vt.engine.forward")
    assert {"vt.engine.input", "vt.engine.output", "vt.model.encoder", "vt.model.decoder",
            "vt.model.regularize", "vt.model.down.spatial", "vt.model.down.temporal",
            "vt.model.up.spatial", "vt.model.up.temporal", "vt.kernel.fused_spatial_resblock", "vt.kernel.fused_temporal_resblock",
            "vt.kernel.subpixel_interleave", "vt.kernel.decoder_tail_rgb"} <= set(got)
    assert sum(n.startswith("vt.kernel.") for n in got) == calls
    assert "vt.stream.cache" not in got and "vt.engine.enc_chunk" not in got


def test_tiled_forward_spans(tok, tmp_path):
    tok.use_tiling = tok.use_overlap = True
    try:
        x = clip()
        s = traced(tmp_path, lambda: tok(x))
        t_latent = tok.encode(x).shape[2]
    finally:
        tok.use_tiling = tok.use_overlap = False
    got = names(s)
    check_nesting(s, "vt.engine.forward")
    assert got.count("vt.engine.enc_chunk") == len(tok.build_chunk_start_end(CLIP[2])) == 3
    assert got.count("vt.engine.dec_chunk") == len(
        tok.build_chunk_start_end(t_latent, decoder_mode=True))
    assert "vt.engine.encode_chunk" not in got
    for i, p in enumerate(s.spans):
        if p.name in ("vt.model.encoder", "vt.model.decoder"):
            assert ancestors(s, i)[0] in ("vt.engine.enc_chunk", "vt.engine.dec_chunk")
        if p.name == "vt.stream.cache":
            up = ancestors(s, i)
            assert "vt.model.encoder" in up or "vt.model.decoder" in up
    assert {"vt.stream.cache", "vt.kernel.fused_temporal_resblock_stream",
            "vt.model.up.temporal", "vt.model.down.temporal"} <= set(got)


def test_encode_chunk_spans(tok, tmp_path):
    x = clip()
    _, _, cache = tok.encode_chunk(x[:, :, :1])
    s = traced(tmp_path, lambda: tok.encode_chunk(x[:, :, 1:5], cache))
    got = names(s)
    check_nesting(s, "vt.engine.encode_chunk")
    assert {"vt.engine.input", "vt.engine.output", "vt.model.encoder", "vt.model.regularize",
            "vt.stream.cache", "vt.kernel.fused_temporal_resblock_stream"} <= set(got)
    assert "vt.model.decoder" not in got


def test_training_forward_spans(tok, tmp_path):
    x = clip().permute(0, 2, 3, 4, 1)
    s = traced(tmp_path, lambda: tok.core.forward_train(x))
    assert {"vt.model.encoder", "vt.model.decoder", "vt.model.regularize"} <= set(names(s))


def test_builds_count_operand_relayouts(monkeypatch):
    @_lib.wrapper
    def probe(block, f32=False):
        return block_operands((block.norm1.norm.weight, block.norm1.norm.bias),
                              (block.conv1.conv.weight, block.conv1.conv.bias),
                              (block.norm2.norm.weight, block.norm2.norm.bias),
                              (block.conv2.conv.weight, block.conv2.conv.bias), f32)

    monkeypatch.setitem(K.WRAPPERS, "probe", probe)
    K.reset_counts()
    b1, b2 = (ResnetBlockTemporal(32, 32, "layernorm", "replicate") for _ in range(2))
    seen = []
    for block, f32 in ((b1, False), (b1, False), (b2, False), (b1, True), (b1, True)):
        probe(block, f32)
        seen.append(K.counts("builds")["probe"])
    assert seen == [1, 1, 2, 3, 3]
    b1.load_state_dict({k: v.clone() for k, v in b1.state_dict().items()})
    probe(b1)
    probe(b1)
    assert K.counts("builds")["probe"] == 4 and K.counts("calls")["probe"] == 7
    assert K.counts("launches")["probe"] == 0
    K.reset_counts()
    assert K.counts("builds")["probe"] == 0 and K.counts("calls")["probe"] == 0


# -- the benchmark's reader --------------------------------------------------

def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# the C++ RecordFunction's spans are cpu_op events, record_function's
# user_annotation ones: both are read
SPANS = [_x("vt.engine.forward", "cpu_op", 10, 890),
         _x("vt.model.encoder", "cpu_op", 20, 380),
         _x("vt.kernel.fused_spatial_resblock", "cpu_op", 30, 30),
         _x("vt.stream.cache", "cpu_op", 100, 20),
         _x("vt.model.decoder", "user_annotation", 400, 480),
         _x("vt.kernel.decoder_tail_rgb", "user_annotation", 800, 50)]
LAUNCHED = [_x("cudaLaunchKernel", "cuda_runtime", 40, 5, corr=1),       # kernel A
            _x("cudaMemcpyAsync", "cuda_runtime", 110, 5, corr=2),       # stream cache
            _x("cudaLaunchKernel", "cuda_runtime", 400.5, 5, corr=3),    # decoder
            _x("cuLaunchKernel", "cuda_driver", 820, 5, corr=4),         # kernel D
            _x("cudaLaunchKernel", "cuda_runtime", 950, 5, corr=5),      # no vt span
            _x("cudaLaunchKernel", "cuda_runtime", 45, 5, tid=2, corr=6)]  # other thread
DEVICE = [_x("void vt::wg::conv_kernel<0, 128>(int)", "kernel", 100, 100, 7, 1),
          _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 210, 30, 7, 2),
          _x("sm90_xmma_fprop_implicit_gemm", "kernel", 600, 100, 7, 3),
          _x("void vt::tail_kernel<128>(int)", "kernel", 860, 20, 7, 4),
          _x("elementwise_kernel", "kernel", 960, 20, 7, 5),
          _x("elementwise_kernel", "kernel", 300, 10, 7, 6),
          _x("Memset (Device)", "gpu_memset", 990, 20, 7)]  # no launch; 10 in the window


def synthetic(tmp_path, with_spans: bool = True):
    events = [_x(WINDOW, "user_annotation", 0, 1000), _x("aten::cat", "cpu_op", 100, 10),
              _x("vt.model.encoder", "cpu_op", 500, 10, tid=2)] + (SPANS if with_spans else [])
    path = tmp_path / ("with.json" if with_spans else "without.json")
    path.write_text(json.dumps({"traceEvents": events + LAUNCHED + DEVICE}))
    return path


def test_spans_attribute_device_time_through_correlation(tmp_path):
    s = spans.read(synthetic(tmp_path))
    assert [p.name for p in s.spans] == [e["name"] for e in SPANS]
    parents = [None if p.parent is None else s.spans[p.parent].name for p in s.spans]
    assert parents == [None, "vt.engine.forward", "vt.model.encoder", "vt.model.encoder",
                       "vt.engine.forward", "vt.model.decoder"]
    assert [p.ops for p in s.spans] == [4, 2, 1, 1, 2, 1]
    want = {"vt.model.encoder": 130, "vt.model.decoder": 120, "vt.stream.cache": 30,
            "vt.kernel.": 120, "vt.kernel.decoder_tail_rgb": 20, "vt.engine.forward": 250,
            "vt.engine.": 250, "vt.model.regularize": 0}
    for name, us in want.items():
        assert s.device_under(name) == pytest.approx(us * 1e-6), name
    assert s.unattributed_s == pytest.approx((20 + 10 + 10) * 1e-6)
    assert s.device_s == pytest.approx(290e-6)
    assert [o.launched for o in s.ops] == [40, 110, 400.5, 820, 950, None, None]
    assert spans.read(synthetic(tmp_path, False)) is None


NEW = ["encoder_ms.fps", "encoder_ms.lat", "decoder_ms.fps", "decoder_ms.lat",
       "stream_cache_ms.fps", "stream_cache_ms.lat", "kernel_host_us.lat",
       "operand_rebuild.fps", "operand_rebuild.lat"]
# on the synthetic trace, two requests of 17 frames; the counters 2 builds
# in 8 calls
READS = {"encoder_ms.fps": 0.130 / 34, "encoder_ms.lat": 0.130 / 2,
         "decoder_ms.fps": 0.120 / 34, "decoder_ms.lat": 0.120 / 2,
         "stream_cache_ms.fps": 0.030 / 34, "stream_cache_ms.lat": 0.030 / 2,
         "kernel_host_us.lat": (30 + 50) / 2,
         "operand_rebuild.fps": 25.0, "operand_rebuild.lat": 25.0}


def ctx(path):
    records = [SimpleNamespace(frames=17), SimpleNamespace(frames=17)]
    return SimpleNamespace(traced={"path": str(path), "records": records})


def set_counts(monkeypatch, calls: int, builds: int):
    for fn in K.WRAPPERS.values():
        monkeypatch.setattr(fn, "calls", 0)
        monkeypatch.setattr(fn, "builds", 0)
    monkeypatch.setattr(K.WRAPPERS["fused_spatial_resblock"], "calls", calls)
    monkeypatch.setattr(K.WRAPPERS["decoder_tail_rgb"], "builds", builds)


@pytest.mark.parametrize("name", NEW)
def test_new_metric_reads_the_trace(name, tmp_path, monkeypatch):
    spec = {m["name"]: m for m in json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
            ["per_layer"]}[name]
    assert spec["source"] == ("program_counter" if name.startswith("operand_rebuild")
                              else "program_span")
    set_counts(monkeypatch, 8, 2)
    read = harness.load_metric(harness.BENCH_DIR, name)
    assert read(ctx(synthetic(tmp_path))) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", NEW)
def test_new_metric_is_none_without_spans_or_counter(name, tmp_path, monkeypatch):
    read = harness.load_metric(harness.BENCH_DIR, name)
    if name.startswith("operand_rebuild"):
        set_counts(monkeypatch, 0, 0)
        assert read(ctx(synthetic(tmp_path))) is None  # no call counted
        for fn in K.WRAPPERS.values():
            monkeypatch.delattr(fn, "builds")
    assert read(ctx(synthetic(tmp_path, with_spans=False))) is None


CONV = {"conv_tiles_per_block.fps": ("frames_per_s", ["flagship-t201-pipelined",
                                                       "v1_1-tiled-t201-pipelined"]),
        "conv_tiles_per_block.lat": ("latency_p95_ms", ["flagship-t17-latency",
                                                        "v1_1-stream16-latency"])}


def set_conv_counts(monkeypatch, counts: dict):
    for name, fn in K.WRAPPERS.items():
        tiles, blocks = counts.get(name, (0, 0))
        monkeypatch.setattr(fn, "conv_tiles", tiles)
        monkeypatch.setattr(fn, "conv_blocks", blocks)


def test_count_conv_adds_a_plans_tiles_and_grid(monkeypatch):
    """``_lib.count_conv`` on a stub plan adds its tiles and grid once per
    launch; ``reset_counts()`` zeroes both counters of every wrapper."""
    set_conv_counts(monkeypatch, {})
    fn = K.WRAPPERS["fused_temporal_resblock"]
    stub = SimpleNamespace(tiles=10_240, grid=264)
    _lib.count_conv(fn, stub, 2)
    _lib.count_conv(fn, SimpleNamespace(tiles=3, grid=3))
    assert (fn.conv_tiles, fn.conv_blocks) == (20_483, 531)
    assert K.counts("conv_tiles")["fused_temporal_resblock"] == 20_483
    K.reset_counts()
    assert set(K.counts("conv_tiles").values()) == set(K.counts("conv_blocks").values()) == {0}


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_tiles_per_block_reads_the_counters(name, tmp_path, monkeypatch):
    """The sum of the wrappers' ``conv_tiles`` over the sum of their
    ``conv_blocks`` (``program_counter``), in the kernels' layer, read in
    the cells of the end-to-end metric it moves."""
    spec = {m["name"]: m for m in json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
            ["per_layer"]}[name]
    moves, cells = CONV[name]
    assert (spec["source"], spec["unit"], spec["better"], spec["moves"], spec["workloads"],
            spec["layer"]) == ("program_counter", "tiles/block", "higher", moves, cells,
                               "Kernels: ops/kernels and csrc")
    set_conv_counts(monkeypatch, {"fused_spatial_resblock": (20_480, 528),
                                  "parity_up2x_fused": (10_240, 132),
                                  "fused_temporal_resblock": (64, 64)})
    read = harness.load_metric(harness.BENCH_DIR, name)
    assert read(ctx(synthetic(tmp_path))) == pytest.approx((20_480 + 10_240 + 64) / (528 + 132 + 64))


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_tiles_per_block_is_none_without_the_counters(name, tmp_path, monkeypatch):
    """Nothing where no conv was launched, and nothing, without raising, on
    a program whose wrappers keep no such counters (the parent of the
    persistent loop)."""
    read = harness.load_metric(harness.BENCH_DIR, name)
    set_conv_counts(monkeypatch, {})
    assert read(ctx(synthetic(tmp_path))) is None
    for fn in K.WRAPPERS.values():
        monkeypatch.delattr(fn, "conv_tiles")
        monkeypatch.delattr(fn, "conv_blocks")
    assert read(ctx(synthetic(tmp_path))) is None


# -- VidTwin's spans ----------------------------------------------------------

VIDTWIN = VR.tiny(json.loads((harness.BENCH_DIR / "configs" /
                              "vidtwin_structure_7_7_8_dynamics_7_8.json").read_text()))
VIDTWIN_CLIP = (1, 3, 16, 32, 32)


@pytest.fixture(scope="module")
def twin():
    return load_model_from_config(VIDTWIN, device="cpu")


def test_vidtwin_no_range_while_nothing_records(twin, monkeypatch, tmp_path):
    made = []
    real = P._RANGE

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(P, "_RANGE", counted)
    x = torch.rand(VIDTWIN_CLIP, generator=torch.Generator().manual_seed(1)) * 2 - 1
    twin(x)
    assert made == []
    traced(tmp_path, lambda: twin(x))
    assert {"vt.engine.forward", "vt.model.attn.temporal", "vt.model.qformer"} <= set(made)


def test_vidtwin_forward_spans(twin, tmp_path):
    x = torch.rand(VIDTWIN_CLIP, generator=torch.Generator().manual_seed(2)) * 2 - 1
    s = traced(tmp_path, lambda: twin(x))
    got = names(s)
    check_nesting(s, "vt.engine.forward")
    depth = twin.model.encoder.depth + twin.model.decoder.depth
    want = {"vt.engine.input": 1, "vt.engine.output": 1, "vt.model.encoder": 1,
            "vt.model.decoder": 1, "vt.model.attn.spatial": depth,
            "vt.model.attn.temporal": depth, "vt.model.structure": 2, "vt.model.qformer": 1,
            "vt.model.dynamics": 2, "vt.model.regularize": 3}
    assert {n: got.count(n) for n in want} == want
    assert not any(n.startswith(("vt.kernel.", "vt.stream.")) for n in got)
    for i, p in enumerate(s.spans):
        up = ancestors(s, i)
        if p.name.startswith("vt.model.attn."):
            assert up[0] in ("vt.model.encoder", "vt.model.decoder"), (p.name, up)
        if p.name == "vt.model.qformer":
            assert up[0] == "vt.model.structure"
        if p.name in ("vt.model.structure", "vt.model.dynamics"):
            assert up == ["vt.engine.forward"]


def test_vidtwin_encode_and_decode_spans(twin, tmp_path):
    x = torch.rand(VIDTWIN_CLIP, generator=torch.Generator().manual_seed(3)) * 2 - 1
    latents = twin.encode(x)[:3]
    s = traced(tmp_path, lambda: twin.decode(*latents))
    check_nesting(s, "vt.engine.decode")
    got = names(s)
    assert {"vt.engine.input", "vt.engine.output", "vt.model.decoder",
            "vt.model.structure", "vt.model.dynamics"} <= set(got)
    assert "vt.model.encoder" not in got and "vt.model.qformer" not in got
    s = traced(tmp_path, lambda: twin.encode(x))
    check_nesting(s, "vt.engine.encode")
    assert "vt.model.decoder" not in names(s) and "vt.model.qformer" in names(s)


# a VidTwin request's spans on the synthetic trace's clock: two attention
# branches of the encoder, the structure pathway with its Q-Former, a
# decoder launch outside both
VIDTWIN_SPANS = [_x("vt.engine.forward", "cpu_op", 10, 890),
                 _x("vt.model.encoder", "cpu_op", 20, 380),
                 _x("vt.model.attn.spatial", "cpu_op", 30, 40),
                 _x("vt.model.attn.temporal", "cpu_op", 80, 60),
                 _x("vt.model.structure", "cpu_op", 410, 100),
                 _x("vt.model.qformer", "cpu_op", 420, 50),
                 _x("vt.model.decoder", "cpu_op", 600, 280)]
VIDTWIN_LAUNCHED = [_x("cudaLaunchKernel", "cuda_runtime", 40, 5, corr=11),     # spatial
                    _x("cudaMemcpyAsync", "cuda_runtime", 100, 5, corr=12),     # temporal copy
                    _x("cudaLaunchKernel", "cuda_runtime", 430, 5, corr=13),    # Q-Former
                    _x("cudaLaunchKernel", "cuda_runtime", 500, 5, corr=14),    # pyramid
                    _x("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=15)]    # decoder MLP
VIDTWIN_DEVICE = [_x("sm90_xmma_gemm_bf16bf16", "kernel", 100, 100, 7, 11),
                  _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 210, 30, 7, 12),
                  _x("fmha_cutlassF", "kernel", 450, 20, 7, 13),
                  _x("cudnn_conv", "kernel", 520, 10, 7, 14),
                  _x("elementwise_kernel", "kernel", 720, 50, 7, 15)]
# device ms under each span over the two 512-frame requests of ctx()
VIDTWIN_READS = {"spatial_attn_ms.fps": 0.100 / 1024, "temporal_attn_ms.fps": 0.030 / 1024,
                 "structure_ms.fps": 0.030 / 1024, "encoder_ms.fps": 0.130 / 1024,
                 "decoder_ms.fps": 0.050 / 1024}


def vidtwin_ctx(tmp_path, with_spans: bool = True):
    events = [_x(WINDOW, "user_annotation", 0, 1000)] + (VIDTWIN_SPANS if with_spans else [])
    path = tmp_path / ("twin.json" if with_spans else "twin_without.json")
    path.write_text(json.dumps({"traceEvents": events + VIDTWIN_LAUNCHED + VIDTWIN_DEVICE}))
    records = [SimpleNamespace(frames=512), SimpleNamespace(frames=512)]
    return SimpleNamespace(traced={"path": str(path), "records": records})


@pytest.mark.parametrize("name", sorted(VIDTWIN_READS))
def test_vidtwin_span_metric_reads_the_trace(name, tmp_path):
    """The three readers of VidTwin's spans (``program_span``, the VidTwin
    layer, the VidTwin cell) and the encoder's and decoder's, which read
    the same cell."""
    spec = {m["name"]: m for m in json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
            ["per_layer"]}[name]
    assert spec["source"] == "program_span" and "vidtwin-t16-pipelined" in spec["workloads"]
    if name not in ("encoder_ms.fps", "decoder_ms.fps"):
        assert (spec["layer"], spec["moves"], spec["workloads"]) == (
            "Model: models/vidtwin (STTransformer, QFormer, VidTwinVAE)", "frames_per_s",
            ["vidtwin-t16-pipelined"])
    read = harness.load_metric(harness.BENCH_DIR, name)
    assert read(vidtwin_ctx(tmp_path)) == pytest.approx(VIDTWIN_READS[name])
    assert read(vidtwin_ctx(tmp_path, with_spans=False)) is None
