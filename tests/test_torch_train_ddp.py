"""Data parallelism on the CPU: two gloo processes (``torch.multiprocessing``,
a file ``init_method``), each training on its half of a batch of 2, against
one process on the whole batch. The tiny FSQ model with the entropy and
commitment losses (FSQ's codebook entropy over the global batch), the 3D
discriminator with BatchNorm (global statistics), ``disc_start`` 0 and
LeCAM on (global logit means), the adaptive weight (averaged ``conv_out``
gradients). After 2 steps every parameter, the BatchNorm statistics, the
EMA, LeCAM's EMAs and every log (``d_weight`` among them) equal the
single process's within rtol 1e-4, atol 1e-6 (fp32 reductions in another
order; lr 1e-6, so a near-zero gradient rounded to the other sign moves a
parameter by at most 2e-6, so the parameters alone cannot show that the
gradients were averaged). The first step's Adam first moments (0.1 x the
averaged, clipped gradient) of both optimizers equal the single
process's on each rank within a relative L2 of 1e-4: that holds the
gradient averaging itself. Between the two steps rank 0 alone serves its
half through ``trainer.tokenizer()``, as the train CLI's image logging
does: serving runs no collective, so the ranks stay paired.
"""

import numpy as np
import torch
import torch.multiprocessing as mp

from tests.test_torch_train_common import clip, config, rel

CFG = config("fsq", "3d", lr=1e-6, lecam_loss_weight=0.1)


def _first_moments(tr):
    """Each optimizer's Adam ``exp_avg``, concatenated in parameter order
    (the parameters it stepped)."""
    return {name: torch.cat([opt.state[p]["exp_avg"].ravel() for p in params
                             if p in opt.state])
            for name, opt, params in (("g", tr.opt_g, tr.params_g),
                                      ("d", tr.opt_d, list(tr.disc.parameters())))}


def _train(x, rank=0, world=1, init=None):
    from vidtok_tpu_torch.parallel.distributed import init_distributed
    from vidtok_tpu_torch.train.trainer import VidTokTrainer

    if world > 1:
        assert init_distributed("gloo", init, world, rank)
    tr = VidTokTrainer(CFG, device="cpu", seed=4).init_state()
    n = x.shape[0] // world
    xs = torch.from_numpy(x[rank * n:(rank + 1) * n])
    logs = [tr.fit_step(xs)]
    moments = _first_moments(tr)
    if rank == 0:
        with torch.no_grad():
            tr.tokenizer()(xs.permute(0, 4, 1, 2, 3))
        tr.core.train()
    logs.append(tr.fit_step(xs))
    sd = tr.state_dict()
    return {"core": sd["core"], "disc": sd["disc"], "ema": sd["ema"], "lecam": sd["lecam"],
            "logs": [{k: float(v) for k, v in l.items()} for l in logs]}, moments


def _worker(rank, x, init, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.save(_train(x, rank, 2, init), f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-4, atol=1e-6, err_msg=path)


def test_two_process_step_equals_one(tmp_path):
    x = clip(6, (2, 5, 16, 16, 3))
    out = str(tmp_path / "rank")
    mp.spawn(_worker, args=(x, f"file://{tmp_path / 'init'}", out), nprocs=2, join=True)
    single, moments = _train(x)
    assert single["logs"][1]["train/d_weight"] > 0
    assert single["logs"][1]["train/aux_loss"] != 0
    for r in range(2):
        ddp, ddp_moments = torch.load(f"{out}.{r}", weights_only=True)
        for k in moments:
            err = rel(ddp_moments[k], moments[k])
            assert err <= 1e-4, (r, k, err)
        _close(ddp, single)
    # the statistics and gradients really are the global batch's: one
    # process's half alone gives other BatchNorm statistics and moments
    half, half_moments = _train(x[:1])
    assert any(not np.allclose(half["disc"][k], single["disc"][k], rtol=1e-4, atol=1e-6)
               for k in single["disc"] if "running" in k)
    assert all(rel(half_moments[k], moments[k]) > 1e-2 for k in moments)
