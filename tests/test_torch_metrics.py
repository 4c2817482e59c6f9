"""The port's quality metrics (``vidtok_tpu_torch/ops/metrics.py``) and
LPIPS (``vidtok_tpu_torch/modules/lpips.py``) against ``vidtok_tpu``'s.

* PSNR and SSIM on videos and frames at 256² (no downscale), 520²
  (``f = round(520 / 256) = 2``, a cropping average pool) and odd sizes,
  and the complex SSIM's per-channel values, within 1e-5 relative of JAX
  on the same inputs (f32 both sides; the reductions run in another
  order).
* LPIPS with JAX's ``init_lpips_params(PRNGKey(0))`` written to an
  ``.npz`` in JAX's layout (``flatten_params``: HWIO kernels) and read by
  ``load_lpips_params``, on 64² images, within 1e-5 relative of JAX's
  ``LPIPS.apply``; an absent file gives None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtok_tpu.modules.lpips import LPIPS as JLPIPS
from vidtok_tpu.modules.lpips import init_lpips_params
from vidtok_tpu.ops import metrics as J
from vidtok_tpu.utils.checkpoint import flatten_params
from vidtok_tpu_torch.modules.lpips import LPIPS, load_lpips_params
from vidtok_tpu_torch.ops import metrics as P

torch.set_num_threads(2)
RTOL = 1e-5


def pair(shape, seed=0):
    """x in [0, 1] and a noisy copy of it, also in [0, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return x, y


SHAPES = {"video_256": (1, 3, 3, 256, 256), "frames_256": (2, 3, 256, 256),
          "video_520": (1, 3, 2, 520, 520), "frames_odd": (3, 3, 37, 53),
          "video_odd_wide": (2, 3, 2, 45, 781)}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("metric", ["compute_psnr", "compute_ssim"])
def test_metric_matches_jax(metric, name):
    x, y = pair(SHAPES[name])
    want = float(getattr(J, metric)(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(P, metric)(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_ssim_downscale_factor():
    """520² frames average 2 x 2 blocks; 45 x 781 frames keep their size."""
    x, y = pair((1, 3, 520, 520))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = P.ssim_per_channel(P._avg_pool2d(tx, 2), P._avg_pool2d(ty, 2))[0].mean()
    assert float(P.compute_ssim(tx, ty)) == float(want)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 2, 19, 27)])
def test_ssim_per_channel_and_complex(shape):
    x, y = pair(shape, seed=1)
    for name, args in (("ssim_per_channel", (x, y)),
                       ("ssim_per_channel_complex",
                        (np.stack([x, y], -1), np.stack([y, 1 - x], -1)))):
        want = getattr(J, name)(*(jnp.asarray(a) for a in args))
        got = getattr(P, name)(*(torch.from_numpy(a) for a in args))
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-7)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "vgg_lpips.npz")
    params = init_lpips_params(jax.random.PRNGKey(0))
    np.savez(path, **flatten_params(jax.device_get(params)))
    return path, params


def test_lpips_matches_jax(lpips_npz):
    path, params = lpips_npz
    x, y = pair((3, 64, 64, 3), seed=2)
    x, y = x * 2 - 1, y * 2 - 1
    want = np.asarray(JLPIPS().apply({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    lp = LPIPS()
    lp.load_state_dict(load_lpips_params(path))
    got = lp(*(torch.from_numpy(a.transpose(0, 3, 1, 2)) for a in (x, y)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1, 1, 1)
    # JAX's [N,1,1,1] keeps the spatial axes where NHWC has them
    np.testing.assert_allclose(got.numpy().reshape(-1), want.reshape(-1), rtol=RTOL)
    assert float(got.min()) > 0


def test_lpips_weights_absent(tmp_path):
    assert load_lpips_params(str(tmp_path / "none.npz")) is None
