"""The VidTwin serving engine (``vidtok_tpu/models/vidtwin/engine.py``):
clips ``[B, C, T, H, W]`` in [-1, 1] in, f32 out; encode to
``(u_S, u_Dx, u_Dy)``, decode, forward, and cross-reenactment (structure
of one clip with the dynamics of another; reference
inference_vidtwin_cross_reconstruct.py:232-239).

The model runs in ``compute_dtype`` (f32, or bf16 with the weights cast at
rest) on ``device``, the card unless the caller names the CPU. An ablation
of the ladder (``ablations.py``) serves ``forward`` only: ``encode``,
``decode`` and ``cross_reenact`` are ``VidTwinVAE``'s (JAX's engine calls
``VidTwinVAE.encode`` by name) and raise on it. Sampling
(``sample=True``) draws from the engine's ``torch.Generator`` on the
device, which advances with every ``encode`` and ``forward`` as JAX's
engine splits its key.

Spans (``utils/profiling.span``): ``vt.engine.forward``, ``.encode``,
``.decode`` around the calls, ``vt.engine.input`` around the clip's or
latents' cast, ``vt.engine.output`` around the f32 casts of the results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...config import load_config
from ...utils import checkpoint
from ...utils.profiling import span
from .vidtwin_ae import VidTwinVAE, build_vidtwin_from_config, reset_params_


class VidTwinTokenizer:
    def __init__(self, model: VidTwinVAE, meta: dict, compute_dtype=None, seed: int = 0):
        self.model = model.eval()
        self.meta = meta
        self.compute_dtype = compute_dtype or torch.float32
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(self.device).manual_seed(seed)

    @classmethod
    def from_config(cls, config, ckpt: Optional[str] = None, seed: int = 0, device="cuda",
                    compute_dtype: Optional[torch.dtype] = None, full_pickle: bool = False):
        """``config``: a dict or a YAML path (which needs PyYAML). Weights
        from ``ckpt`` (a torch ``.ckpt`` / ``.pt``, weights-only unless
        ``full_pickle``, a ``.safetensors`` file or JAX's ``.npz``; loaded
        strictly on the CPU), else random from ``seed``. Without CUDA the
        default device raises."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to build the model "
                               "on the CPU")
        cfg = load_config(config)
        model, meta = build_vidtwin_from_config(cfg.get("model", cfg))
        if ckpt:
            ablation = not isinstance(model, VidTwinVAE)
            sd = checkpoint.read_vidtwin_state_dict(ckpt, full_pickle, ablation)
            checkpoint.load_into(model, sd, model.unused_keys() if ablation else ())
        else:
            reset_params_(model, torch.Generator().manual_seed(seed))
        dtype = compute_dtype or torch.float32
        return cls(model.to(device, dtype), meta, dtype, seed)

    @property
    def input_size(self):
        """(T, H, W) of the clips the model takes."""
        return self.model.encoder.input_size

    def _input(self, x):
        with span("vt.engine.input"):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return x.to(self.device, self.compute_dtype)

    def _vae(self, what: str) -> None:
        if not isinstance(self.model, VidTwinVAE):
            raise TypeError(f"{what} is VidTwinVAE's; the ablation "
                            f"{type(self.model).__name__} serves forward only")

    @torch.no_grad()
    def encode(self, x, sample: bool = False):
        """x [B, C, T, H, W] -> (u_S [B, Fq, h, w, c], u_Dx [B, d, F, W'],
        u_Dy [B, d, F, H'], reg_log), f32."""
        self._vae("encode")
        with span("vt.engine.encode"):
            _, u_s, u_dx, u_dy, log = self.model.encode(self._input(x), sample, self.generator)
            with span("vt.engine.output"):
                return u_s.float(), u_dx.float(), u_dy.float(), log

    @torch.no_grad()
    def decode(self, u_s, u_dx, u_dy, only_part: Optional[str] = None):
        """-> x_rec [B, C, T, H, W], f32."""
        self._vae("decode")
        with span("vt.engine.decode"):
            dec = self.model.decode(self._input(u_s), self._input(u_dx), self._input(u_dy),
                                    only_part=only_part)
            with span("vt.engine.output"):
                return dec.float()

    @torch.no_grad()
    def forward(self, x, sample: bool = False):
        """(z [B, hidden, F, H', W'] (SymDis: 2B), x_rec [B, C, T, H, W],
        reg_log), f32."""
        with span("vt.engine.forward"):
            z, dec, log, _ = self.model(self._input(x), sample, generator=self.generator)
            with span("vt.engine.output"):
                return z.float(), dec.float(), log

    __call__ = forward

    @torch.no_grad()
    def cross_reenact(self, x_structure, x_dynamics):
        """The structure of ``x_structure`` decoded with the dynamics of
        ``x_dynamics``."""
        u_s, _, _, _ = self.encode(x_structure)
        _, u_dx, u_dy, _ = self.encode(x_dynamics)
        return self.decode(u_s, u_dx, u_dy)
