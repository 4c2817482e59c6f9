"""Weights from the JAX package's parameter tree into this package.

``state_dict_from_jax`` inverts the layout map of
``vidtok_tpu/utils/checkpoint.py`` (``convert_torch_state_dict``): JAX
kernels DHWIO become the torch layouts the reference model uses (Conv3d
OIDHW, Conv2d OIHW for the per-frame convs, Conv1d OIk for the temporal
resblock convs), ``scale`` becomes ``weight`` under the LayerNorm wrapper's
``.norm``, and module paths regain their dotted torch form
(``down_0_block_1`` -> ``down.0.block.1``). It needs numpy only.
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
    if kind == "spatial":            # nn.Conv2d: (1,kh,kw,I,O) -> OIHW
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

