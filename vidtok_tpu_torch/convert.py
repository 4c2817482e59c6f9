"""Weights from the JAX package's parameter tree into this package.

``state_dict_from_jax`` inverts the layout map of
``vidtok_tpu/utils/checkpoint.py`` (``convert_torch_state_dict``): JAX
kernels DHWIO become the torch layouts the reference model uses (Conv3d
OIDHW, Conv2d OIHW for the per-frame convs, Conv1d OIk for the temporal
resblock convs), Dense kernels IO become Linear weights OI (FSQ's
``project_in`` / ``project_out``), ``scale`` becomes ``weight`` under the
LayerNorm wrapper's ``.norm``, and module paths regain their dotted torch
form (``down_0_block_1`` -> ``down.0.block.1``). It needs numpy only.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_STRUCT = [
    # (pattern, dotted form, kind of the module it names)
    (re.compile(r"^(down|up)_(\d+)_block_(\d+)$"), r"\1.\2.block.\3", "spatial"),
    (re.compile(r"^(down_temporal|up_temporal)_(\d+)_block_(\d+)$"),
     r"\1.\2.block.\3", "temporal"),
    (re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$"), r"\1.\2.\3", "spatial"),
    (re.compile(r"^(down_temporal|up_temporal)_(\d+)_(downsample|upsample)$"),
     r"\1.\2.\3", "3d"),
    (re.compile(r"^mid_(block_1|block_2|attn_1)$"), r"mid.\1", "3d"),
]
_NORMS = {"norm", "norm1", "norm2", "norm_out"}


def _struct(name: str):
    for pat, rep, kind in _STRUCT:
        if pat.match(name):
            return pat.sub(rep, name), kind
    return name, "3d"


def _conv(prefix: str, p: dict, kind: str, out: dict) -> None:
    k = np.asarray(p["kernel"])
    if k.ndim == 2:                  # nn.Linear (FSQ's projections): IO -> OI
        key, w = prefix, k.T
    elif kind == "spatial":          # nn.Conv2d: (1,kh,kw,I,O) -> OIHW
        key, w = prefix, k[0].transpose(3, 2, 0, 1)
    elif kind == "temporal":         # CausalConv1d(.conv): (k,1,1,I,O) -> OIk
        key, w = prefix + ".conv", k[:, 0, 0].transpose(2, 1, 0)
    else:                            # CausalConv3d(.conv): DHWIO -> OIDHW
        key, w = prefix + ".conv", k.transpose(4, 3, 0, 1, 2)
    out[key + ".weight"] = np.ascontiguousarray(w)
    out[key + ".bias"] = np.asarray(p["bias"])


def _walk(tree: dict, prefix: str, kind: str, out: dict) -> None:
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            if name != "mix_factor":
                raise KeyError(f"unexpected leaf {prefix}{name}")
            out[prefix + name] = np.asarray(sub).reshape(1)
        elif name in _NORMS:
            out[f"{prefix}{name}.norm.weight"] = np.asarray(sub["scale"])
            out[f"{prefix}{name}.norm.bias"] = np.asarray(sub["bias"])
        elif "kernel" in sub:
            _conv(prefix + name, sub, kind, out)
        else:
            dotted, sub_kind = _struct(name)
            _walk(sub, f"{prefix}{dotted}.", sub_kind, out)


def state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """Nested ``TokenizerCore`` params (numpy leaves) -> flat state dict of
    numpy arrays with this package's (the reference torch model's) keys."""
    out: Dict[str, np.ndarray] = {}
    for top, tree in params.items():
        name = "regularization" if top == "regularizer" else top
        _walk(tree, name + ".", "3d", out)
    return out



def _disc_index(name: str, n_layers: int) -> int:
    """JAX's discriminator module name -> its index in the reference's
    ``main`` Sequential (the inverse of ``checkpoint.py``'s
    ``_DISC_SEQ_NAMES``, for any depth)."""
    if name == "conv_out":
        return 3 * n_layers + 2
    n = int(name[4:])
    return 0 if name == "conv0" else 3 * n - 1 if name.startswith("conv") else 3 * n


def discriminator_state_dict_from_jax(params: dict, batch_stats: dict = None,
                                      n_layers: int = 3) -> Dict[str, np.ndarray]:
    """JAX ``NLayerDiscriminator(3D)`` params and batch stats -> the
    reference torch module's state dict (``main.<i>.*``; the inverse of
    ``vidtok_tpu/utils/checkpoint.py:162-207``): kernels HWIO / DHWIO
    become OIHW / OIDHW, BatchNorm ``scale``/``bias``/``mean``/``var``
    become ``weight``/``bias``/``running_mean``/``running_var`` (with
    ``num_batches_tracked`` 0; no buffers without ``batch_stats``, for a
    tree shaped like the params, such as Adam's moments), ActNorm's ``[C]`` ``loc``/``scale`` become
    ``[1, C, 1, ...]`` with ``initialized`` 1."""
    out: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        pre = f"main.{_disc_index(name, n_layers)}."
        if "kernel" in p:
            k = np.asarray(p["kernel"])
            out[pre + "weight"] = np.ascontiguousarray(
                np.moveaxis(k, (-1, -2), (0, 1)))
            if "bias" in p:
                out[pre + "bias"] = np.asarray(p["bias"])
        elif "loc" in p:
            # the input's rank is the kernel's (HWIO: 4, DHWIO: 5)
            shape = (1, -1) + (1,) * (np.ndim(params["conv0"]["kernel"]) - 2)
            out[pre + "loc"] = np.asarray(p["loc"]).reshape(shape)
            out[pre + "scale"] = np.asarray(p["scale"]).reshape(shape)
            out[pre + "initialized"] = np.array(1, np.uint8)
        else:
            out[pre + "weight"] = np.asarray(p["scale"])
            out[pre + "bias"] = np.asarray(p["bias"])
            if batch_stats is not None:
                out[pre + "running_mean"] = np.asarray(batch_stats[name]["mean"])
                out[pre + "running_var"] = np.asarray(batch_stats[name]["var"])
                out[pre + "num_batches_tracked"] = np.array(0, np.int64)
    return out
