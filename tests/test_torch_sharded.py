"""The port's H-sharded forward (``VideoTokenizer.forward_sharded`` over a
``parallel/mesh.py`` mesh) on the CPU: two and four gloo processes
(``torch.multiprocessing``, a file ``init_method``), each passing the whole
clip and getting the whole results, against the port's single-process
forward (atol 1e-5, ``tests/test_sharded.py``'s bound) and JAX's
single-device forward (rtol 1e-4, atol 2e-4).

Models (f32), ``kl``, ``fsq`` and ``groupnorm`` with random weights from a
seed in JAX's tree (kernels N(0, 1/fan_in), norm scales 1 +- 0.2, every
other leaf N(0, 0.05²): the norm biases and the temporal conv2 are not
zero) converted to the port's layout and held to JAX too; the other two
with the port's seeded init:

* ``kl``: ``tests/test_sharded.py``'s tiny v1.0 KL model (``ch`` 32,
  one spatial level down, the nearest parity upsample);
* ``fsq``: its FSQ model (levels 5, 3, 3, entropy and commitment losses
  on): indices exactly and ``aux_loss``;
* ``fsq_proj``: the same model's bottleneck with projections and two
  codebooks (``dim`` 3 -> 2 x 3 values, ``diversity_gamma`` 0.5), two
  processes: indices ``[B, T', H', W', 2]`` gathered along H;
* ``groupnorm``: a causal v1.0 groupnorm model at ``ch`` 128 (ROADMAP's
  trap: narrower groupnorm models amplify f32 rounding): the ``frame``
  statistics summed over the slabs;
* ``flagship``: JAX's flagship-topology case (4 levels, ``ch_mult``
  [1, 2, 4, 4], tdf 4, 16 latent channels at ``ch`` 32), four processes:
  a one-row slab (its halo's height) at the deepest level;
* ``sample``: the KL model with ``sample=True``, two processes, against
  the single process's draw from the same seed;
* ``kernel``: the KL model with the tokenizer's kernels on, two
  processes: each slab's nearest temporal upsample goes through kernel
  E's wrapper (its plain version on CPU tensors) and no other wrapper is
  called, as JAX's sharded graph takes Pallas E there and the plain
  graph elsewhere.

The four processes form a 2 x 2 ``(data, spatial)`` mesh (H splits over
all four, as JAX's over all devices); rank 0 loads the weights, the
others start from other ones and ``replicate`` broadcasts rank 0's;
``shard_batch`` gives each rank its data row's half of a batch of 4.
Every rank's whole results are bit-equal to rank 0's. The refusals: an H
that does not split into slabs of a multiple of 8 rows, a tiled model.

The single-process and the sharded runs both take PyTorch's own conv
(oneDNN off) on one thread: oneDNN picks its algorithm by shape, so a
slab's conv with its halo rows and the whole frame's padded conv round
differently from 128 channels up (1 ulp, which the ``groupnorm`` model
amplifies past 1e-5), and the GEMMs' blocking follows the thread count.
So the KL and FSQ models come out bit-equal; the ``groupnorm`` model
differs by the order of its slab sums (7.3e-6 measured on the
reconstruction, against the 1e-5 bound), the flagship topology by 3.8e-6.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

# tests/test_sharded.py:13-21 and :43-57
_P = {"double_z": True, "z_channels": 4, "in_channels": 3, "out_ch": 3,
      "ch": 32, "ch_mult": [1, 2], "time_downsample_factor": 2,
      "num_res_blocks": 1, "norm_type": "layernorm",
      "tempo_ds": [0], "tempo_us": [1]}
_FSQ_P = dict(_P, double_z=False, z_channels=3)
_FLAGSHIP_P = dict(_P, z_channels=16, ch_mult=[1, 2, 4, 4], time_downsample_factor=4,
                   num_res_blocks=2, tempo_ds=[0, 1], tempo_us=[1, 2])


def _cfg(p, reg):
    return {"params": {
        "encoder_config": {"target": "EncoderCausal3D", "params": dict(p)},
        "decoder_config": {"target": "DecoderCausal3D", "params": dict(p)},
        "regularizer_config": reg}}


KL = {"target": "DiagonalGaussianRegularizer"}
FSQ = {"target": "FSQRegularizer", "params": {
    "levels": [5, 3, 3], "entropy_loss_weight": 0.1,
    "entropy_loss_annealing_steps": 10, "entropy_loss_annealing_factor": 3,
    "commitment_loss_weight": 0.25}}
FSQ_PROJ = {"target": "FSQRegularizer", "params": dict(
    FSQ["params"], dim=3, num_codebooks=2, diversity_gamma=0.5)}
# name -> (config, clip shape, sample, worlds)
CASES = {
    "kl": (_cfg(_P, KL), (1, 3, 5, 32, 32), False, (2, 4)),
    "fsq": (_cfg(_FSQ_P, FSQ), (1, 3, 5, 32, 32), False, (2, 4)),
    "groupnorm": (_cfg(dict(_P, ch=128, norm_type="groupnorm"), KL), (1, 3, 5, 32, 32),
                  False, (2, 4)),
    "flagship": (_cfg(_FLAGSHIP_P, KL), (1, 3, 5, 32, 32), False, (4,)),
    "sample": (_cfg(_P, KL), (1, 3, 5, 32, 32), True, (2,)),
    "kernel": (_cfg(_P, KL), (1, 3, 5, 32, 32), False, (2,)),
    # last, so that the cases above keep their seeds (enumerated in ``runs``)
    "fsq_proj": (_cfg(_FSQ_P, FSQ_PROJ), (1, 3, 5, 32, 32), False, (2,)),
}
# the cases held to JAX too (weights from JAX's tree); the others take the
# port's seeded init
JAX_CASES = ("kl", "fsq", "fsq_proj", "groupnorm")
TOL = dict(rtol=1e-4, atol=2e-4)
ATOL_SINGLE = 1e-5


def _tokenizer(case, sd=None, seed=0):
    from vidtok_tpu_torch import load_model_from_config
    from vidtok_tpu_torch.utils.checkpoint import load_into

    tok = load_model_from_config({"model": CASES[case][0]}, device="cpu", seed=seed)
    if sd is not None:
        load_into(tok.core, sd)
    return tok


@contextlib.contextmanager
def _threads(n):
    """``n`` intra-op threads for the block (the ranks run one each: the
    GEMMs' blocking, and so their rounding, follows the thread count)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _worker(rank, world, init, inputs, out):
    import torch.distributed as dist

    from vidtok_tpu_torch.ops import kernels as K
    from vidtok_tpu_torch.parallel.distributed import init_distributed
    from vidtok_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    assert init_distributed("gloo", init, world, rank)
    mesh = make_mesh(n_spatial=2)
    got = {"batch": shard_batch(mesh, torch.arange(4.0).reshape(4, 1)),
           "mesh": (mesh.shape, mesh.index), "calls": {}}
    data = torch.load(inputs, weights_only=True)
    for case, (_, _, sample, worlds) in CASES.items():
        if world not in worlds:
            continue
        sd, x = data[case]
        tok = _tokenizer(case, sd if rank == 0 else None, seed=1 + rank)
        tok.generator.manual_seed(0)  # the single process's seed: its draw
        replicate(mesh, tok.core)
        tok.fused = case == "kernel"
        K.reset_counts()
        z, dec, log = tok.forward_sharded(x, mesh, sample=sample)
        got[case] = {"z": z, "dec": dec, **log}
        got["calls"][case] = K.counts("calls")
    torch.save(got, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


def _jax_params(cfg, shape, seed):
    """JAX core and random params of ``cfg`` for a clip of ``shape``."""
    import jax
    import jax.numpy as jnp

    from vidtok_tpu.models.autoencoder import build_core_from_config

    core, _ = build_core_from_config(cfg)
    b, c, t, h, w = shape
    v = jax.eval_shape(lambda: core.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((b, t, h, w, c)), sample_override=False))
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return r / np.sqrt(np.prod(a.shape[:-1]))
        return 1.0 + 0.2 * r if name.endswith("['scale']") else 0.05 * r

    return core, jax.tree_util.tree_map_with_path(leaf, v["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's forward, the port's single-process forward, and each
    world's ranks' sharded results."""
    import jax
    import jax.numpy as jnp

    from vidtok_tpu_torch.convert import state_dict_from_jax

    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, ref = {}, {}
    for i, (case, (cfg, shape, sample, _)) in enumerate(CASES.items()):
        x = np.clip(np.random.RandomState(20 + i).randn(*shape) * 0.5, -1, 1).astype(np.float32)
        if case in JAX_CASES:
            core, params = _jax_params(cfg, shape, seed=10 + i)
            sd = {k: torch.from_numpy(np.array(v))
                  for k, v in state_dict_from_jax(params).items()}
            zj, dj, lj = jax.jit(lambda p, x: core.apply(
                {"params": p}, x, sample_override=False))(params, jnp.asarray(
                    x.transpose(0, 2, 3, 4, 1)))
            ref[case] = {"jax": (np.asarray(zj).transpose(0, 4, 1, 2, 3),
                                 np.asarray(dj).transpose(0, 4, 1, 2, 3),
                                 {k: np.asarray(v) for k, v in lj.items()})}
        else:  # the port's own seeded init
            sd = _tokenizer(case, seed=10 + i).core.state_dict()
            ref[case] = {}
        inputs[case] = (sd, torch.from_numpy(x))
        tok = _tokenizer(case, sd)
        with torch.backends.mkldnn.flags(enabled=False), _threads(1):
            z, dec, log = tok(x, sample=sample)
            ref[case]["single"] = {"z": z, "dec": dec, **log}
            if sample:
                ref[case]["mode"] = tok(x)[1]
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    sharded = {}
    for world in (2, 4):
        out = str(tmp / f"rank{world}")
        mp.spawn(_worker, args=(world, f"file://{tmp / f'init{world}'}", path, out),
                 nprocs=world, join=True)
        sharded[world] = [torch.load(f"{out}.{r}", weights_only=True) for r in range(world)]
    return ref, sharded


@pytest.mark.parametrize("case,world", [(c, w) for c, v in CASES.items() for w in v[3]])
def test_sharded_equals_single(runs, case, world):
    ref, sharded = runs
    got = sharded[world][0]
    for other in sharded[world][1:]:  # every rank returns the whole results
        for k, v in got[case].items():
            assert torch.equal(other[case][k], v), k
    single = ref[case]["single"]
    for k in ("z", "dec"):
        assert got[case][k].shape == single[k].shape
        np.testing.assert_allclose(got[case][k].numpy(), single[k].numpy(), rtol=0,
                                   atol=ATOL_SINGLE, err_msg=k)
    loss = "aux_loss" if "aux_loss" in single else "kl_loss"
    np.testing.assert_allclose(float(got[case][loss]), float(single[loss]), rtol=1e-5)
    if case == "sample":  # the draw, not the mode
        assert not torch.allclose(got[case]["dec"], ref[case]["mode"], atol=1e-3)
    if case not in JAX_CASES:
        return
    zj, dj, lj = ref[case]["jax"]
    np.testing.assert_allclose(got[case]["z"].numpy(), zj, **TOL)
    np.testing.assert_allclose(got[case]["dec"].numpy(), dj, **TOL)
    np.testing.assert_allclose(float(got[case][loss]), float(lj[loss]), rtol=1e-4)
    if "indices" in single:
        np.testing.assert_array_equal(got[case]["indices"].numpy(), single["indices"].numpy())
        np.testing.assert_array_equal(got[case]["indices"].numpy(), lj["indices"])


def test_sharded_parity_kernel(runs):
    """Kernel E's wrapper runs once per nearest temporal upsample on each
    rank's slab where the tokenizer's kernels are on, and no wrapper runs
    where they are off."""
    from vidtok_tpu_torch.modules.blocks import TimeUpsampleRes2x
    from vidtok_tpu_torch.ops import kernels as K

    _, sharded = runs
    n = sum(isinstance(m, TimeUpsampleRes2x) and m.parity
            for m in _tokenizer("kernel").core.modules())
    assert n > 0
    want = dict(dict.fromkeys(K.WRAPPERS, 0), parity_up2x_fused=n)
    for got in sharded[2]:
        assert got["calls"]["kernel"] == want
        for case, calls in got["calls"].items():
            assert case == "kernel" or not any(calls.values()), (case, calls)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_and_batch(runs, world):
    """Ranks in row-major order of the ``(data, spatial)`` grid; each data
    row's ranks get that row's half of the batch (the whole batch when
    there is one row)."""
    _, sharded = runs
    rows = world // 2
    for rank, got in enumerate(sharded[world]):
        assert got["mesh"] == ((rows, 2), rank)
        want = torch.arange(4.0).reshape(4, 1).chunk(rows)[rank // 2]
        assert torch.equal(got["batch"], want)


def test_refusals():
    from vidtok_tpu_torch.parallel.mesh import Mesh, make_mesh

    tok = _tokenizer("kl")
    two = Mesh(np.arange(2).reshape(1, 2), None, None, None, 0)
    x = torch.zeros(1, 3, 5, 40, 40)
    with pytest.raises(ValueError, match="does not split into 2 slabs"):
        tok.forward_sharded(x, two)  # 40 / 8 = 5 rows a level-0 slab pair
    one = make_mesh()
    assert one.size == 1 and one.index == 0 and one.group is None
    z, dec, _ = tok.forward_sharded(x, one)  # one slab: the plain forward
    z1, dec1, _ = tok(x)
    torch.testing.assert_close(z, z1, rtol=0, atol=ATOL_SINGLE)
    torch.testing.assert_close(dec, dec1, rtol=0, atol=ATOL_SINGLE)
    tiled = load_v1_1_tiled()
    with pytest.raises(ValueError, match="tiled"):
        tiled.forward_sharded(torch.zeros(1, 3, 9, 32, 32), one)


def load_v1_1_tiled():
    from vidtok_tpu_torch import load_model_from_config

    cfg = {"params": {
        "encoder_config": {"target": "EncoderCausal3DV1_1", "params": dict(_P)},
        "decoder_config": {"target": "DecoderCausal3DV1_1", "params": dict(_P)},
        "regularizer_config": KL}}
    tok = load_model_from_config({"model": cfg}, device="cpu")
    tok.use_tiling = True
    return tok


def test_no_shard_left_behind():
    """The shard is set on the modules for the call only: no module holds
    it after the call, nor after a call that raised."""
    from vidtok_tpu_torch.parallel.mesh import make_mesh, shard_of

    tok = _tokenizer("kl")
    seen = []
    hook = tok.core.decoder.conv_out.register_forward_pre_hook(
        lambda m, a: seen.append(shard_of(m)))
    tok.forward_sharded(torch.zeros(1, 3, 5, 16, 16), make_mesh())
    hook.remove()
    assert seen and seen[0] is not None
    assert not any(shard_of(m) for m in tok.core.modules())

    def fail(*args, **kwargs):
        raise RuntimeError("decoder failed")

    tok.core.decoder.forward = fail
    with pytest.raises(RuntimeError, match="decoder failed"):
        tok.forward_sharded(torch.zeros(1, 3, 5, 16, 16), make_mesh())
    assert not any(shard_of(m) for m in tok.core.modules())
