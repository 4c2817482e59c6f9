"""Phases 3-13 and 18-20 of the card gate: every configuration served on
its kernel path, its launches per forward checked against the call model
(PER_FORWARD, ``tiled_per_forward``), and held end to end to its plain
path by one routine (``e2e_gate``) running a gate that is data
(``e2e_bf16``, ``e2e_tiled``, ``e2e_tiled_partial``, ``e2e_f32``). Each
phase's function says what it serves and gates:

3. the causal v1.0 KL 4x8x8 16-channel flagship at full width with seeded
   random weights in bf16 (``serve_both_paths``), its gate at REQUEST and
   at PARTIAL_REQUEST (a 33² latent: partial tiles in A-E);
4. one [1, 3, 201, 256, 256] clip, bench.py's protocol
   (``serve_long_clip``);
5. the v1.0 FSQ 4096 tokenizer, its indices checked (``check_fsq``);
6. the causal v1.1 KL 4x8x8 16-channel tokenizer as in 3;
7. the same v1.1 tokenizer tiled (``serve_tiled``);
8. the v1.0 flagship in the other kernel forms (``serve_forms``);
9. the non-causal KL 4x8x8 16-channel model as in 3 at [1, 3, 16, 256,
   256] (B, D, E and F not launched: they are causal-only);
10 and 10c. the v1.1 FSQ 4x16x16 262144 model and the non-causal FSQ
   262144 model (``check_fsq_262144``); 10b. the FSQ 4096 flagship with
   FSQ's other options (``serve_fsq_options``);
11. the v1.1 FSQ 8x8x8 32768 model tiled (``serve_tiled_888``);
12. the v1.0 KL 4x4x4 model (``serve_444``);
13. the checkpoint round trip (``checkpoint_round_trip``);
18. the public surface (``serve_public_surface``);
19. f32 through the kernels, the engine's default on the card
    (``serve_f32``);
20. other channel widths through the kernels (``serve_widths``).
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np

from chip_smoke import (BF16_SLACK, CH32_CFG, CH32_REQUEST, CKPT_DIR, CONFIG_PATHS,
                        F32_E2E_GATE, F32_FORMS, FORMS, FSQ_888_CFG, FSQ_CFG, FSQ_DECODE_GATE,
                        FSQ_OPTIONS, FSQ_OPTIONS_CFG, KL_444_CFG, LONG_REQUEST, N_REQUESTS,
                        PARTIAL_REQUEST, PER_FORWARD, REQUEST, ROOT, TDF, TILED_LONG,
                        TILED_MEM_RATIO, TILED_RECON_GATE, TILED_REQUEST, TILED_Z_GATE,
                        T_CHUNK_ENC, V1_0_CFG, V1_1_CFG, WIDTHS, chunk_schedule, f32_calls,
                        in_forms, model_calls, per_forward, randomize_, rel_l2,
                        tiled_per_forward, width_override)


def clip(seed: int, shape) -> np.ndarray:
    """A request of ``shape`` from ``seed``: N(0, 0.5²) clipped to [-1, 1]."""
    return np.clip(np.random.RandomState(seed).randn(*shape) * 0.5, -1, 1).astype(np.float32)


def check_outputs(what: str, tok, shape, z, dec, log) -> None:
    """z and the reconstruction of a ``shape`` request through ``tok`` have
    their shapes, and they and the regularizer's loss are finite."""
    import torch

    z_ch = next(tok.core.decoder.conv_in.parameters()).shape[1]
    down = 2 ** len(tok.core.encoder.spatial_ds)
    loss = "aux_loss" if tok.meta["discrete"] else "kl_loss"
    t_lat = -(-shape[2] // tok.time_downsample_factor)
    if (tuple(dec.shape) != tuple(shape)
            or tuple(z.shape) != (shape[0], z_ch, t_lat, shape[3] // down, shape[4] // down)):
        raise AssertionError(f"{what}: shapes z {tuple(z.shape)} dec {tuple(dec.shape)}")
    if not (torch.isfinite(z).all() and torch.isfinite(dec).all()
            and torch.isfinite(log[loss])):
        raise AssertionError(f"{what}: non-finite output")


def serve(tok, n_requests: int, shape, per_forward: dict) -> dict:
    """Answer ``n_requests`` requests; host-clock latency per request ending
    in ``torch.cuda.synchronize()``; each forward must launch the kernels
    ``per_forward`` times and give outputs that ``check_outputs`` passes.
    The counts are set to 0 before the first request and returned as
    ``launches``; ``last`` is (x, z, x_rec, reg_log) of the last
    request."""
    import torch

    from vidtok_tpu_torch.ops import kernels

    reqs = [clip(1 + i, shape) for i in range(n_requests)]
    torch.cuda.reset_peak_memory_stats()
    lat = []
    kernels.reset_counts()
    for x in reqs:
        before = kernels.counts()
        t0 = time.perf_counter()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        after = kernels.counts()
        per = {k: after[k] - before[k] for k in after}
        if per != per_forward:
            raise AssertionError(f"launches per forward {per} != {per_forward}")
        check_outputs("serve", tok, shape, z, dec, log)
    return dict(latency_s=lat, launches=kernels.counts(),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                last=(x, z, dec, log))


def report(what: str, r: dict, shape, dtype: str = "bf16") -> None:
    print(f"serve {what}; request {list(shape)} {dtype}; latency_s "
          + " ".join(f"{v:.4f}" for v in r["latency_s"])
          + f"; peak_mem_bytes {r['peak_mem_bytes']}; launches {r['launches']}",
          flush=True)


def kernel_forms(path: str = None):
    """The ``KernelForms`` of a FORMS path; the default forms for None."""
    from vidtok_tpu_torch import KernelForms

    return KernelForms() if path is None else KernelForms(*FORMS[path][0])


# The end-to-end gates. Two bf16 evaluations of this 60-block network
# differ by 2-3% relative L2 whatever the kernels do (bf16 rounding
# accumulated through the residual stream), so a bf16 kernel path is held
# to the plain bf16 path's own distance from an f32 plain run: no further
# from it than the plain bf16 path is (x BF16_SLACK), on z and on the
# reconstruction; an f32 kernel path to its plain f32 path within
# F32_E2E_GATE. Each gate is data (``Gate``): the engines it runs, the
# pairs of runs it reads, and the rules it holds the readings to;
# ``e2e_gate`` runs any of them and ``e2e_rule`` applies the rules.
class Run(NamedTuple):
    """One engine of an end-to-end gate on the model under test: ``key``
    names its outputs; its compute dtype (a torch dtype's name), the
    kernel path on or off, its KernelForms (a FORMS path; None: the
    default forms), tiling (with overlap), and the launches a forward of
    the kernel path must make (the plain path must make none)."""
    key: str
    dtype: str
    fused: bool = False
    forms: str = None
    tiled: bool = False
    launches: dict = None


class Gate(NamedTuple):
    """An end-to-end gate: the label of its printed line, its runs, the
    pairs of runs whose rel_l2 on z and on the reconstruction it reads
    (``{z,recon}_{a}_vs_{b}``), the pairs whose FSQ indices it compares
    where the runs give indices (``indices_{a}_vs_{b}``, the share
    unlike), its rules (see ``e2e_rule``), the clip's seed, and whether
    each run's outputs move to the host, its memory freed, before the
    next run."""
    label: str
    runs: tuple
    pairs: tuple
    rules: tuple
    index_pairs: tuple = ()
    seed: int = 100
    host: bool = False


def slack(key: str, ref: str, whats=("z", "recon")) -> tuple:
    """Rules: run ``key`` no further from run ``ref`` than BF16_SLACK x the
    plain bf16 run is, on each of ``whats``."""
    return tuple((f"{w}_{key}_vs_{ref}", BF16_SLACK, f"{w}_plain_vs_{ref}") for w in whats)


# FSQ with its options (phase 10b): the kernel path's share of indices
# unlike the f32 plain run's, against the plain bf16 path's (bf16's spread
# moves 5-6% of them on either path: no fixed share holds)
FLIP_RULE = ("indices_kernel_vs_f32", BF16_SLACK, "indices_plain_vs_f32")


def e2e_bf16(shape, path: str, kernels=("kernel",)) -> Gate:
    """Phase 3's gate at ``shape``: each of ``kernels``, the kernel path in
    bf16 in the default forms (``kernel``, PER_FORWARD[path] launches) or
    in the forms of a FORMS path (its own), held by ``slack`` to the f32
    plain run (``f32``); each one's distance from the plain bf16 path
    (``plain``) printed beside."""
    runs = tuple(Run(k, "bfloat16", True, None if k == "kernel" else k,
                     launches=PER_FORWARD[path if k == "kernel" else k]) for k in kernels)
    runs += (Run("plain", "bfloat16"), Run("f32", "float32"))
    pairs = tuple((k, ref) for k in kernels for ref in ("plain", "f32")) + (("plain", "f32"),)
    rules = tuple(r for w in ("z", "recon") for k in kernels for r in slack(k, "f32", (w,)))
    return Gate(f"e2e {list(shape)}", runs, pairs, rules,
                tuple((k, "f32") for k in kernels + ("plain",)))


def e2e_tiled(shape) -> Gate:
    """Phase 7's gate at ``shape``, each run's outputs on the host: the
    tiled kernel path (bf16) held by ``slack`` to the non-tiled f32 plain
    run, and to the tiled f32 plain run, which takes tiling's own
    departure out of the comparison; the tiled kernel path in the forms of
    ``tiled_forms`` to the tiled f32 plain run likewise; and the tiled f32
    plain run within TILED_Z_GATE of the non-tiled one on z, within
    TILED_RECON_GATE on the reconstruction (see there)."""
    per = tiled_per_forward(shape[2], shape[3])
    runs = (Run("kernel", "bfloat16", True, tiled=True, launches=per),
            Run("tiled_forms", "bfloat16", True, "tiled_forms", True,
                in_forms(per, "tiled_forms")),
            Run("plain", "bfloat16", tiled=True), Run("tiled_f32", "float32", tiled=True),
            Run("untiled_f32", "float32"))
    pairs = tuple((k, ref) for ref in ("untiled_f32", "tiled_f32")
                  for k in ("kernel", "tiled_forms", "plain")) + (("tiled_f32", "untiled_f32"),)
    rules = ()
    for w, bound in (("z", TILED_Z_GATE), ("recon", TILED_RECON_GATE)):
        for k, ref in (("kernel", "untiled_f32"), ("kernel", "tiled_f32"),
                       ("tiled_forms", "tiled_f32")):
            rules += slack(k, ref, (w,))
        rules += ((f"{w}_tiled_f32_vs_untiled_f32", bound, None),)
    return Gate("tiled e2e", runs, pairs, rules, host=True)


def e2e_tiled_partial() -> Gate:
    """Phase 7's tiled PARTIAL_REQUEST (a 33² latent: partial tiles in
    every kernel of the tiled path) on the kernel path, held by ``slack``
    to the tiled f32 plain run; outputs on the host."""
    per = tiled_per_forward(PARTIAL_REQUEST[2], PARTIAL_REQUEST[3])
    runs = (Run("kernel", "bfloat16", True, tiled=True, launches=per),
            Run("plain", "bfloat16", tiled=True), Run("tiled_f32", "float32", tiled=True))
    return Gate(f"tiled partial request {list(PARTIAL_REQUEST)} launches {per};", runs,
                (("kernel", "tiled_f32"), ("plain", "tiled_f32")),
                slack("kernel", "tiled_f32"), seed=101, host=True)


def e2e_f32(shape, per: dict, what: str, forms: str = None, tiled: bool = False) -> Gate:
    """Phase 19's gate: the f32 kernel path (``per`` launches; in the forms
    of FORMS path ``forms``; tiled or not) against the plain f32 path (TF32
    off), z and the reconstruction within F32_E2E_GATE; outputs on the
    host."""
    runs = (Run("kernel_f32", "float32", True, forms, tiled, per),
            Run("plain_f32", "float32", tiled=tiled))
    rules = tuple((f"{w}_kernel_f32_vs_plain_f32", F32_E2E_GATE, None) for w in ("z", "recon"))
    return Gate(f"f32 e2e {what} {list(shape)}", runs, (("kernel_f32", "plain_f32"),), rules,
                host=True)


def e2e_readings(outs: dict, pairs, index_pairs=()) -> dict:
    """rel_l2 of z and of the reconstruction for each pair of runs of
    ``outs`` (run -> (z, reconstruction, indices or None)); then, for each
    index pair whose runs gave indices, the share of them unlike."""
    res = {f"{what}_{a}_vs_{b}": rel_l2(outs[a][i], outs[b][i])
           for i, what in enumerate(("z", "recon")) for a, b in pairs}
    for a, b in index_pairs:
        if outs[a][2] is not None:
            res[f"indices_{a}_vs_{b}"] = float((outs[a][2] != outs[b][2]).float().mean())
    return res


def e2e_rule(res: dict, rules, label: str) -> None:
    """Raise on the first of ``rules`` that the readings ``res`` break,
    naming it. A rule (reading, limit, base) holds res[reading] <= limit x
    res[base], or <= limit where base is None."""
    for reading, limit, base in rules:
        bound = limit if base is None else limit * res[base]
        if not res[reading] <= bound:
            raise AssertionError(f"{label}: {reading} {res[reading]} > {limit}"
                                 + ("" if base is None else f" x {base} {res[base]}"))


def e2e_gate(core, meta, shape, gate: Gate) -> dict:
    """Run ``gate`` on the model (``core``, ``meta``): each run on one
    ``shape`` clip drawn from the gate's seed, its launches and outputs
    checked (``check_outputs``); then the readings, printed on one line and
    held to the gate's rules. Returns the readings."""
    import torch

    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer
    from vidtok_tpu_torch.ops import kernels as K

    x = clip(gate.seed, shape)
    outs = {}
    for run in gate.runs:
        tok = VideoTokenizer(core, meta, getattr(torch, run.dtype), fused=run.fused,
                             forms=kernel_forms(run.forms))
        tok.use_tiling = run.tiled
        if run.tiled:
            tok.use_overlap = True
        K.reset_counts()
        z, dec, log = tok(x)
        torch.cuda.synchronize()
        want = run.launches if run.fused else dict.fromkeys(K.WRAPPERS, 0)
        if K.counts() != want:
            raise AssertionError(f"{gate.label} {run.key}: launches {K.counts()} != {want}")
        blend = K.WRAPPERS["temporal_linear_blend"]
        if blend.base_frames:  # the trilinear upsample: two output frames an input frame
            print(f"{gate.label} {run.key}: blend base_frames {blend.base_frames} up_frames "
                  f"{blend.up_frames}", flush=True)
            if 2 * blend.base_frames != blend.up_frames:
                raise AssertionError(f"{gate.label} {run.key}: the blend wrote "
                                     f"{blend.up_frames} frames of {blend.base_frames}")
        check_outputs(f"{gate.label} {run.key}", tok, shape, z, dec, log)
        outs[run.key] = tuple(t.cpu() if gate.host and t is not None else t
                              for t in (z, dec, log.get("indices")))
        del tok, z, dec, log
        if gate.host:
            torch.cuda.empty_cache()
    res = e2e_readings(outs, gate.pairs, gate.index_pairs)
    print(f"{gate.label} rel_l2 " + json.dumps(res), flush=True)
    e2e_rule(res, gate.rules, gate.label)
    return res


def make_tokenizer(cfg: dict, device, seed: int = 0):
    """A full-width engine with ``randomize_`` weights, built on the CPU
    and moved to ``device``, bf16 compute, the kernel path on."""
    import torch

    from vidtok_tpu_torch import load_model_from_config
    from vidtok_tpu_torch.models.autoencoder import VideoTokenizer

    tok = load_model_from_config(cfg, seed=seed, device="cpu",
                                 compute_dtype=torch.bfloat16)
    randomize_(tok.core, seed=seed)
    return VideoTokenizer(tok.core.to(device), tok.meta, torch.bfloat16,
                          fused=True)


def serve_both_paths(name: str, cfg: dict, path: str, device, shape=REQUEST,
                     n_params_want: int = None) -> dict:
    """Phases 3, 6, 9 and 20: N_REQUESTS requests of ``shape`` on the kernel
    path, then the end-to-end gate, which runs the plain path too (v1.0
    and phase 20's flagship widths: also at PARTIAL_REQUEST);
    ``n_params_want``: the parameters the model must have. Returns the
    kernel path's ``serve`` result."""
    tok = make_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params_want is not None and n_params != n_params_want:
        raise AssertionError(f"{name}: {n_params} parameters, not {n_params_want}")
    per = PER_FORWARD[path]
    k = serve(tok, N_REQUESTS, shape, per)
    report(f"kernel path: {name}, {n_params} params", k, shape)
    for kernel, n in k["launches"].items():
        if n != N_REQUESTS * per[kernel]:
            raise AssertionError(f"{kernel}: {n} launches in the serving run")
    e2e_gate(tok.core, tok.meta, shape, e2e_bf16(shape, path))
    if path == "v1_0" or path in WIDTHS:
        # a 33² latent: partial tiles in A, B, C, D and E
        e2e_gate(tok.core, tok.meta, PARTIAL_REQUEST, e2e_bf16(PARTIAL_REQUEST, path))
    return k


def serve_long_clip(device) -> None:
    """Phase 4: one LONG_REQUEST through the v1.0 kernel path, after one
    warm-up request of the same shape."""
    tok = make_tokenizer(V1_0_CFG, device)
    r = serve(tok, 2, LONG_REQUEST, PER_FORWARD["v1_0"])
    report("long clip, kernel path: v1.0 kl 4x8x8 16chn (request 1 is the "
           "warm-up)", r, LONG_REQUEST)


def check_fsq(device, name="fsq 4096, kernel path: v1.0 fsq 4x8x8 4096 codes",
              path="v1_0", n_requests=N_REQUESTS, tok=None) -> dict:
    """Phase 5 (and 10-11): ``n_requests`` requests through an FSQ kernel
    path (the v1.0 FSQ 4096 model's at REQUEST, or a CONFIG_PATHS path's,
    or ``tok``'s at the shape of ``path``; the first pays cuDNN's algorithm
    search, so the latency to compare is the best after it); on the last, integer indices in [0, codebook size)
    of the latent's shape, ``indices_to_latent`` equal to the quantized z,
    decoding from indices equal to the reconstruction (relative L2 <=
    FSQ_DECODE_GATE), a finite ``aux_loss``. Returns the ``serve``
    result."""
    import torch

    cfg, shape, _ = CONFIG_PATHS.get(path, (FSQ_CFG, REQUEST, False))
    tok = tok or make_tokenizer(cfg, device)
    reg = tok.core.regularization
    codes = reg.fsq.codebook_size
    r = serve(tok, n_requests, shape, PER_FORWARD[path])
    report(name, r, shape)
    x, z, dec, log = r["last"]
    idx = log["indices"]
    want = (shape[0],) + tuple(z.shape[2:]) + ((reg.num_codebooks,)
                                               if reg.num_codebooks > 1 else ())
    if (idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != want
            or int(idx.min()) < 0 or int(idx.max()) >= codes):
        raise AssertionError(f"fsq indices {idx.dtype} {tuple(idx.shape)} "
                             f"[{int(idx.min())}, {int(idx.max())}]")
    # the f32 latent, rounded as the forward rounds it (codes are exact in
    # bf16; project_out's f32 output is not)
    latent = tok.indices_to_latent(idx).to(tok.compute_dtype).float()
    # v1.1 decodes tdf * T' frames, of which the forward keeps the last T
    dec_idx = tok.decode(idx, decode_from_indices=True)[:, :, -dec.shape[2]:]
    torch.cuda.synchronize()
    rel = rel_l2(dec_idx, dec)
    print(f"fsq: indices {tuple(idx.shape)} in [{int(idx.min())}, "
          f"{int(idx.max())}], {int(idx.unique().numel())} distinct codes; "
          f"indices_to_latent == z: {torch.equal(latent, z)}; decode from "
          f"indices vs forward rel_l2 {rel:.4g} (bit-equal: "
          f"{torch.equal(dec_idx, dec)}); aux_loss {float(log['aux_loss']):.6g}",
          flush=True)
    if not torch.equal(latent, z):
        raise AssertionError("fsq: indices_to_latent(indices) != quantized z")
    if not rel <= FSQ_DECODE_GATE:
        raise AssertionError(f"fsq: decode from indices rel_l2 {rel}")
    if not torch.isfinite(log["aux_loss"]):
        raise AssertionError("fsq: non-finite aux_loss")
    return r


def check_fsq_262144(device, label: str, name: str, path: str, tok=None) -> None:
    """Phases 10 and 10c: one request through an FSQ 262144 model's kernel
    path (the v1.1 41616 model's, five levels and a 16² latent; or the
    non-causal model's), checked as in ``check_fsq``; its peak memory
    beside the f32 ``[positions, 262144]`` matrix of the entropy loss,
    which it computes on every call as JAX does."""
    r = check_fsq(device, name, path, n_requests=1, tok=tok)
    positions, codes = int(np.prod(r["last"][1].shape[2:])), 8 ** 6
    print(f"{label}: {positions} latent positions, entropy-loss matrix "
          f"[{positions}, {codes}] f32 = {positions * codes * 4} bytes; "
          f"peak_mem_bytes {r['peak_mem_bytes']}", flush=True)


def serve_fsq_options(device) -> None:
    """Phase 10b: FSQ_OPTIONS_CFG, the FSQ 4096 flagship with projections,
    two codebooks, ``diversity_gamma`` and ``inv_temperature``: N_REQUESTS
    requests checked as in ``check_fsq`` (indices ``[1, 5, 32, 32, 2]``,
    decoding from them equal to the forward's), then ``e2e_bf16`` with
    FLIP_RULE: the kernel path within BF16_SLACK x the plain bf16 distance
    from the f32 plain run on z and the reconstruction, and with at most
    BF16_SLACK x the plain bf16 path's share of indices unlike the f32
    run's."""
    tok = make_tokenizer(FSQ_OPTIONS_CFG, device)
    reg = tok.core.regularization
    if not (reg.has_projections and reg.num_codebooks == 2
            and reg.inv_temperature == FSQ_OPTIONS["inv_temperature"]
            and reg.diversity_gamma == FSQ_OPTIONS["diversity_gamma"]):
        raise AssertionError(f"fsq options not built: {reg}")
    check_fsq(device, "fsq options, kernel path: v1.0 fsq 4x8x8, project_in 4 -> 2 "
              "codebooks of 4096, diversity_gamma 0.5, inv_temperature 10", tok=tok)
    gate = e2e_bf16(REQUEST, "v1_0")
    e2e_gate(tok.core, tok.meta, REQUEST, gate._replace(rules=gate.rules + (FLIP_RULE,)))


class _Unquantized:
    """A stand-in regularizer that returns the encoder's output as it is,
    so the tiled engine's encode gives the latent before quantization."""

    def __call__(self, z, sample=None, generator=None, n_steps=0, global_batch=False):
        return z, {"kl_loss": z.new_zeros(())}


def serve_tiled_888(device) -> None:
    """Phase 11: the v1.1 FSQ 8x8x8 32768 model tiled (``use_tiling``,
    ``use_overlap``, ``t_chunk_enc`` 16, so ``t_chunk_dec`` 2): one request
    of its CONFIG_PATHS shape, checked as in ``check_fsq``, then held to the
    tiled f32 plain run with the encoder and the decoder apart (a code that
    flips at a rounding boundary would swamp a comparison of codes): the
    latent before quantization, and the reconstruction decoded from the f32
    run's codes, of the kernel path (bf16) no further from the f32 plain
    run than BF16_SLACK x the plain bf16 path is."""
    import torch

    from vidtok_tpu_torch.models.autoencoder import TokenizerCore, VideoTokenizer

    tok = make_tokenizer(FSQ_888_CFG, device)
    tok.use_tiling, tok.use_overlap = True, True
    if (tok.t_chunk_enc, tok.t_chunk_dec) != (T_CHUNK_ENC, T_CHUNK_ENC // 8):
        raise AssertionError(f"chunks {tok.t_chunk_enc}/{tok.t_chunk_dec}")
    shape = CONFIG_PATHS["tiled_888"][1]
    print(f"tiled 888 T={shape[2]}: encoder and decoder chunks "
          f"{chunk_schedule(shape[2], 8)}", flush=True)
    check_fsq(device, "tiled 888, kernel path: v1.1 fsq 8x8x8 32768 codes, use_overlap, "
              "t_chunk_enc 16", "tiled_888", n_requests=1, tok=tok)
    core, meta = tok.core, tok.meta
    raw = TokenizerCore(core.encoder, core.decoder, _Unquantized())
    x = clip(102, shape)
    ref = VideoTokenizer(core, meta, torch.float32, fused=False)
    ref.use_tiling, ref.use_overlap = True, True
    codes = ref.encode(x)
    del ref
    outs = {}
    for key, dtype, fused in (("kernel", torch.bfloat16, True),
                              ("plain", torch.bfloat16, False),
                              ("tiled_f32", torch.float32, False)):
        t = VideoTokenizer(raw, dict(meta, discrete=False), dtype, fused=fused)
        t.use_tiling, t.use_overlap = True, True
        latent, dec = t.encode(x), t.decode(codes)
        torch.cuda.synchronize()
        for v in (latent, dec):
            if not torch.isfinite(v).all():
                raise AssertionError(f"tiled 888, {key}: non-finite output")
        outs[key] = (latent.cpu(), dec.cpu())
        del t, latent, dec
        torch.cuda.empty_cache()
    res = {f"{what}_{key}_vs_tiled_f32": rel_l2(outs[key][i], outs["tiled_f32"][i])
           for i, what in enumerate(("latent", "recon")) for key in ("kernel", "plain")}
    print(f"tiled 888 {list(shape)} rel_l2 " + json.dumps(res), flush=True)
    e2e_rule(res, slack("kernel", "tiled_f32", ("latent", "recon")), "tiled 888")


def serve_444(device) -> None:
    """Phase 12: one request through the v1.0 KL 4x4x4 model's kernel path
    (levels 0 and 1 at 256², a 64² latent) with its launches, then the
    end-to-end gate."""
    tok = make_tokenizer(KL_444_CFG, device)
    r = serve(tok, 1, REQUEST, PER_FORWARD["kl_444"])
    report("kl 444, kernel path: v1.0 kl 4x4x4 4chn", r, REQUEST)
    e2e_gate(tok.core, tok.meta, REQUEST, e2e_bf16(REQUEST, "kl_444"))


# Phase 18: the flagship's own file, its decoder target replaced by a name
# that is no variant's
FLAGSHIP_YAML = "configs/vidtok_kl_causal_488_16chn.yaml"
DECODER_TARGET = {"model": {"params": {"decoder_config": {"target": "Decoder"}}}}
FLAGSHIP_PARAMS = 157_949_351


def checkpoint_round_trip(device) -> None:
    """Phase 13: the v1.0 flagship saved with ``VideoTokenizer.save`` and
    loaded back through ``load_model_from_config(cfg, ckpt=...)`` (read on
    the CPU, moved to the card); the weights and one request's z and
    reconstruction bit-equal to the model it was saved from; the save and
    load times and the file's size. The file is removed."""
    import torch

    from vidtok_tpu_torch import load_model_from_config

    tok = make_tokenizer(V1_0_CFG, device)
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "flagship.ckpt")
    try:
        t0 = time.perf_counter()
        tok.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = load_model_from_config(V1_0_CFG, ckpt=path, device=device,
                                      compute_dtype=torch.bfloat16, fused=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    same_weights = all(torch.equal(a, b) for a, b in zip(
        tok.core.state_dict().values(), back.core.state_dict().values()))
    x = clip(103, REQUEST)
    z, dec, _ = tok(x)
    z2, dec2, _ = back(x)
    torch.cuda.synchronize()
    same = torch.equal(z, z2) and torch.equal(dec, dec2)
    print(f"checkpoint: {size} bytes; save {save_s:.3f} s, load_model_from_config "
          f"with ckpt {load_s:.3f} s; weights equal {same_weights}; z and "
          f"reconstruction bit-equal {same}", flush=True)
    if not (same_weights and same):
        raise AssertionError("checkpoint round trip changed the model")


def serve_public_surface(device) -> None:
    """Phase 18: the v1.0 flagship built from ``merge_configs(FLAGSHIP_YAML,
    DECODER_TARGET)`` (its decoder target ``Decoder``, which names no
    variant and so takes the encoder's, as JAX's ``build_core_from_config``
    does) through ``load_model_from_config(..., device="cuda",
    compute_dtype=torch.bfloat16)``, so the kernel path is on; against the
    flagship built from the file alone with the same seed: both
    FLAGSHIP_PARAMS parameters, the state dicts equal (as built, and after
    ``randomize_``), z and the reconstruction bit-equal on N_REQUESTS
    requests of REQUEST; the request latency and peak memory on a line of
    their own, the launches per forward (PER_FORWARD["v1_0"]) and phase 3's
    end-to-end gate; then ``core.regularize(core.encode_raw(x,
    fused=True))`` bit-equal to ``core.encode(x, fused=True)`` (the mode:
    ``sample=False``), and the posterior's ``var`` and ``nll(mode)``
    finite."""
    import torch

    from vidtok_tpu_torch import load_model_from_config, merge_configs
    from vidtok_tpu_torch.modules.regularizers import DiagonalGaussian

    path = os.path.join(ROOT, FLAGSHIP_YAML)
    toks = {name: load_model_from_config(cfg, seed=0, device=device,
                                         compute_dtype=torch.bfloat16)
            for name, cfg in (("merged", merge_configs(path, DECODER_TARGET)),
                              ("file", path))}
    tok, ref = toks["merged"], toks["file"]
    n_params = sum(p.numel() for p in tok.core.parameters())
    variants = (tok.core.encoder.variant, tok.core.decoder.variant)
    if not tok.fused or variants != ("causal", "causal") or n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"merged flagship: fused {tok.fused}, variants {variants}, "
                             f"{n_params} params")

    def same_weights():
        a, b = tok.core.state_dict(), ref.core.state_dict()
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    built_equal = same_weights()
    for t in toks.values():
        randomize_(t.core, seed=0)
    if not (built_equal and same_weights()):
        raise AssertionError(f"state dicts unlike: as built {built_equal}, randomized "
                             f"{same_weights()}")
    reqs = [clip(1 + i, REQUEST) for i in range(N_REQUESTS)]
    for i, x in enumerate(reqs):
        z, dec, _ = tok(x)
        z2, dec2, _ = ref(x)
        if not (torch.equal(z, z2) and torch.equal(dec, dec2)):
            raise AssertionError(f"request {i}: the merged flagship's z or "
                                 "reconstruction unlike the file's")
    r = serve(tok, N_REQUESTS, REQUEST, PER_FORWARD["v1_0"])
    report(f"kernel path: v1.0 kl flagship merged with decoder target Decoder, "
           f"{n_params} params", r, REQUEST)
    print("public surface: request latency_s "
          + " ".join(f"{v:.4f}" for v in r["latency_s"])
          + f"; peak_mem_bytes {r['peak_mem_bytes']}; state dicts equal; z and "
          f"reconstruction bit-equal to the file's flagship on {N_REQUESTS} requests",
          flush=True)
    e2e_gate(tok.core, tok.meta, REQUEST, e2e_bf16(REQUEST, "v1_0"))
    x = tok._input(reqs[0])
    with torch.no_grad():
        zp = tok.core.encode_raw(x, fused=True)
        z_a, log_a = tok.core.regularize(zp, sample=False)
        z_b, log_b = tok.core.encode(x, sample=False, fused=True)
        post = DiagonalGaussian(zp)
        nll, var = post.nll(post.mode()), post.var
    torch.cuda.synchronize()
    split_equal = torch.equal(z_a, z_b) and torch.equal(log_a["kl_loss"], log_b["kl_loss"])
    finite = bool(torch.isfinite(nll).all() and torch.isfinite(var).all())
    print(f"public surface: regularize(encode_raw(x)) bit-equal to encode(x) "
          f"{split_equal}; moments {list(zp.shape)} {zp.dtype}; nll(mode) "
          f"{[round(float(v), 1) for v in nll]}; var in [{float(var.min()):.4g}, "
          f"{float(var.max()):.4g}]", flush=True)
    if not (split_equal and finite and nll.shape == (REQUEST[0],)):
        raise AssertionError("encode_raw / regularize unlike encode, or a non-finite "
                             "nll or var")


def serve_tiled(device) -> tuple:
    """Phase 7: the v1.1 tokenizer with ``use_tiling`` and ``use_overlap``:
    N_REQUESTS requests of TILED_REQUEST with the launches per forward of
    ``tiled_per_forward``, one TILED_LONG request whose
    peak memory may be at most TILED_MEM_RATIO x the TILED_REQUEST peak, one
    TILED_REQUEST in the forms of ``tiled_forms``, and the end-to-end
    gates. Returns the ``serve`` results of the TILED_REQUEST runs in the
    default forms and in ``tiled_forms``."""
    import torch

    tok = make_tokenizer(V1_1_CFG, device)
    tok.use_tiling, tok.use_overlap = True, True
    if (tok.t_chunk_enc, tok.t_chunk_dec) != (T_CHUNK_ENC, T_CHUNK_ENC // TDF):
        raise AssertionError(f"chunks {tok.t_chunk_enc}/{tok.t_chunk_dec}")
    for t in (TILED_REQUEST[2], TILED_LONG[2]):
        enc, dec = chunk_schedule(t)
        t_lat = sum(f // TDF for f in enc)
        if ([e - s for s, e in tok.build_chunk_start_end(t)][1:] != enc[1:]
                or [e - s for s, e in tok.build_chunk_start_end(t_lat, True)]
                != [n - (i < len(dec) - 1) for i, n in enumerate(dec)]):
            raise AssertionError(f"T={t}: the engine's chunks differ from "
                                 f"{enc} / {dec}")
        print(f"tiled T={t}: encoder chunks {enc} frames, decoder chunks {dec} "
              f"latents; launches per forward {tiled_per_forward(t)}", flush=True)
    name = "tiled, kernel path: v1.1 kl 4x8x8 16chn, use_overlap, t_chunk_enc 16"
    r = serve(tok, N_REQUESTS, TILED_REQUEST, tiled_per_forward(TILED_REQUEST[2]))
    report(name, r, TILED_REQUEST)
    torch.cuda.empty_cache()
    long = serve(tok, 1, TILED_LONG, tiled_per_forward(TILED_LONG[2]))
    report(name + " (one request, the first at T=201)", long, TILED_LONG)
    ratio = long["peak_mem_bytes"] / r["peak_mem_bytes"]
    print(f"tiled peak memory T=201 / T=65: {ratio:.4f}", flush=True)
    if not ratio <= TILED_MEM_RATIO:
        raise AssertionError(f"tiled peak memory grows with the clip: {ratio}")
    del long
    torch.cuda.empty_cache()
    tok.forms = kernel_forms("tiled_forms")
    r_forms = serve(tok, 1, TILED_REQUEST,
                    in_forms(tiled_per_forward(TILED_REQUEST[2]), "tiled_forms"))
    report(f"{name}, {tok.forms}", r_forms, TILED_REQUEST)
    tok.forms = kernel_forms()
    torch.cuda.empty_cache()
    e2e_gate(tok.core, tok.meta, TILED_REQUEST, e2e_tiled(TILED_REQUEST))
    torch.cuda.empty_cache()
    e2e_gate(tok.core, tok.meta, PARTIAL_REQUEST, e2e_tiled_partial())
    return r, r_forms


def serve_forms(device) -> dict:
    """Phase 8: the v1.0 flagship in the forms of ``v1_0_forms`` (N_REQUESTS
    requests) and of ``v1_0_split`` (one request),
    each with its launches per forward, then the end-to-end gate for both.
    Returns the ``serve`` results by FORMS path."""
    tok = make_tokenizer(V1_0_CFG, device)
    runs = {}
    for path, n in (("v1_0_forms", N_REQUESTS), ("v1_0_split", 1)):
        tok.forms = kernel_forms(path)
        runs[path] = serve(tok, n, REQUEST, PER_FORWARD[path])
        report(f"forms {tok.forms}, kernel path: v1.0 kl 4x8x8 16chn", runs[path],
               REQUEST)
    e2e_gate(tok.core, tok.meta, REQUEST,
             e2e_bf16(REQUEST, "v1_0", kernels=("v1_0_forms", "v1_0_split")))
    return runs


def f32_tokenizer(cfg: dict, device, seed: int = 0):
    """``load_model_from_config(cfg, device=device,
    compute_dtype=torch.float32)`` as a user calls it (``fused`` at its
    default, which must be on), with ``randomize_`` weights (drawn on a CPU
    copy and loaded)."""
    import torch

    from vidtok_tpu_torch import load_model_from_config

    tok = load_model_from_config(cfg, seed=seed, device=device,
                                 compute_dtype=torch.float32)
    if not tok.fused:
        raise AssertionError("f32 on the card: fused is off by default")
    cpu = load_model_from_config(cfg, seed=seed, device="cpu", compute_dtype=torch.float32)
    randomize_(cpu.core, seed=seed)
    tok.core.load_state_dict(cpu.core.state_dict())
    return tok


def serve_f32_forms(tok, path: str, label: str, shapes) -> dict:
    """One f32 request of ``tok`` in the forms of F32_FORMS ``path``, timed
    with its launches per forward (``f32_calls``), then ``e2e_f32``
    against the plain f32 path at each of ``shapes`` (the first the
    request's); the default forms again after. Returns the ``serve``
    result."""
    from vidtok_tpu_torch import KernelForms

    tok.forms = kernel_forms(F32_FORMS[path])
    per = per_forward(f32_calls()[path])
    r = serve(tok, 1, shapes[0], per)
    del r["last"]
    report(f"f32 kernel path in forms {tok.forms}: {label}", r, shapes[0], "f32")
    for shape in shapes:
        e2e_gate(tok.core, tok.meta, shape, e2e_f32(shape, per, f"{label}, forms {tok.forms}",
                                                    F32_FORMS[path], tok.use_tiling))
    tok.forms = KernelForms()
    return r


def serve_f32(device) -> dict:
    """Phase 19: f32 through the kernels, the engine's default on the card.
    (a) the v1.0 flagship from ``f32_tokenizer`` (FLAGSHIP_PARAMS
    parameters): N_REQUESTS requests of REQUEST with PER_FORWARD["v1_0"]
    launches each (latency, peak memory), 2 requests on the plain f32 path
    (the same engine, ``fused`` off), ``e2e_f32`` at REQUEST and at
    PARTIAL_REQUEST (a 33² latent), then ``serve_f32_forms`` in the forms
    of ``v1_0_forms_f32`` and ``v1_0_split_f32`` at both shapes; (b) the
    v1.1 model tiled (``use_overlap``, ``t_chunk_enc`` 16): N_REQUESTS
    requests of TILED_REQUEST with ``tiled_per_forward``'s launches, 2
    requests on the tiled plain f32 path, ``e2e_f32`` against it, then
    ``serve_f32_forms`` in the forms of ``tiled_forms_f32``. Returns
    {F32_PATHS' path: the kernel path's ``serve`` result}."""
    import torch

    runs = {}
    tok = f32_tokenizer(V1_0_CFG, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"flagship: {n_params} parameters, not {FLAGSHIP_PARAMS}")
    for path, label, shape, per, tiled in (
            ("v1_0_f32", f"v1.0 kl 4x8x8 16chn, {n_params} params", REQUEST,
             PER_FORWARD["v1_0"], False),
            ("tiled_f32", "tiled v1.1 kl 4x8x8 16chn, use_overlap, t_chunk_enc 16",
             TILED_REQUEST, tiled_per_forward(TILED_REQUEST[2]), True)):
        if tiled:
            del tok
            torch.cuda.empty_cache()
            tok = f32_tokenizer(V1_1_CFG, device)
            tok.use_tiling, tok.use_overlap = True, True
        r = serve(tok, N_REQUESTS, shape, per)
        report(f"f32 kernel path (the default): {label}", r, shape, "f32")
        tok.fused = False
        plain = serve(tok, 2, shape, dict.fromkeys(per, 0))
        report(f"f32 plain path: {label}", plain, shape, "f32")
        tok.fused = True
        print(f"f32 {label}: kernel path {min(r['latency_s'][1:]):.4f} s against plain "
              f"{min(plain['latency_s']):.4f} s a request", flush=True)
        runs[path] = r
        del r["last"], plain
        torch.cuda.empty_cache()
        e2e_gate(tok.core, tok.meta, shape, e2e_f32(shape, per, label, tiled=tiled))
        if tiled:
            runs["tiled_forms_f32"] = serve_f32_forms(tok, "tiled_forms_f32", label, [shape])
        else:
            e2e_gate(tok.core, tok.meta, PARTIAL_REQUEST, e2e_f32(PARTIAL_REQUEST, per, label))
            for fpath in ("v1_0_forms_f32", "v1_0_split_f32"):
                runs[fpath] = serve_f32_forms(tok, fpath, label, [shape, PARTIAL_REQUEST])
            torch.cuda.empty_cache()
    del tok
    torch.cuda.empty_cache()
    return runs


def serve_width_f32(cfg: dict, path: str, label: str, device, shapes,
                    n_params_want: int = None) -> dict:
    """One f32 request of ``shapes[0]`` through the engine of ``cfg`` on
    its default f32 kernel path (``f32_tokenizer``), PER_FORWARD[path]
    launches, then ``e2e_f32`` against its plain f32 path at each of
    ``shapes``. Returns the ``serve`` result."""
    import torch

    tok = f32_tokenizer(cfg, device)
    n_params = sum(p.numel() for p in tok.core.parameters())
    if n_params_want is not None and n_params != n_params_want:
        raise AssertionError(f"{label}: {n_params} parameters, not {n_params_want}")
    r = serve(tok, 1, shapes[0], PER_FORWARD[path])
    del r["last"]
    report(f"f32 kernel path (the default): {label}, {n_params} params", r, shapes[0], "f32")
    for shape in shapes:
        e2e_gate(tok.core, tok.meta, shape, e2e_f32(shape, PER_FORWARD[path], label))
    del tok
    torch.cuda.empty_cache()
    return r


def serve_widths(device) -> dict:
    """Phase 20: the kernel path at channel widths other than the released
    models'. (a) For each of WIDTHS, the flagship from its file, loaded
    (``load_config``) and merged (``merge_configs``) with ``ch`` set in
    both the encoder's and the decoder's params (``width_override``), its
    launches per forward from ``model_calls`` those of the flagship (A 20,
    B 20, C 3, D 1, E 2): ``serve_both_paths`` (N_REQUESTS bf16 requests
    of REQUEST on the kernel path, the end-to-end gate at REQUEST and at
    PARTIAL_REQUEST) with its parameters checked, then
    ``serve_width_f32`` at both shapes; (b) the CPU tests' ch-32 v1.1 model
    (CH32_CFG; A 6, B 6, C 1, D 1) at CH32_REQUEST: N_REQUESTS bf16
    requests, the end-to-end gate, and ``serve_width_f32``. Returns {path: the kernel
    path's ``serve`` result} (f32 runs under path + "_f32")."""
    import torch

    from vidtok_tpu_torch import load_config, merge_configs

    file = os.path.join(ROOT, FLAGSHIP_YAML)
    runs = {}
    for name, (ch, n_params) in WIDTHS.items():
        cfg = merge_configs(load_config(file), width_override(ch))
        label = f"v1.0 kl 4x8x8 16chn at ch {ch} (merge_configs of {FLAGSHIP_YAML})"
        per = per_forward(model_calls(cfg, REQUEST))
        if not per == PER_FORWARD[name] == PER_FORWARD["v1_0"]:
            raise AssertionError(f"{label}: launches per forward {per}, not the flagship's "
                                 f"{PER_FORWARD['v1_0']}")
        runs[name] = serve_both_paths(label, cfg, name, device, n_params_want=n_params)
        del runs[name]["last"]
        torch.cuda.empty_cache()
        runs[name + "_f32"] = serve_width_f32(cfg, name, label, device,
                                              [REQUEST, PARTIAL_REQUEST], n_params)
    label = "v1.1 kl ch 32 (the CPU tests' model)"
    tok = make_tokenizer(CH32_CFG, device)
    r = serve(tok, N_REQUESTS, CH32_REQUEST, PER_FORWARD["ch32"])
    del r["last"]
    report(f"kernel path: {label}, {sum(p.numel() for p in tok.core.parameters())} params",
           r, CH32_REQUEST)
    e2e_gate(tok.core, tok.meta, CH32_REQUEST, e2e_bf16(CH32_REQUEST, "ch32"))
    runs["ch32"] = r
    del tok
    runs["ch32_f32"] = serve_width_f32(CH32_CFG, "ch32", label, device, [CH32_REQUEST])
    torch.cuda.empty_cache()
    return runs
