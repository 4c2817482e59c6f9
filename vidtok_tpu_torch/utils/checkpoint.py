"""Checkpoint files in and out of the port (the load half of
``vidtok_tpu/utils/checkpoint.py``, ``:209-300``, and its torch writer).

:func:`read_state_dict` reads a flat state dict from

* a torch file (``.ckpt`` / ``.pt``, anything not named below):
  ``torch.load`` on the CPU, its ``["state_dict"]`` when it has one;
* JAX's ``.npz``: ``save_params``' flat ``a/b/c`` keys, or the ``core``
  section of a full-checkpoint npz (``core//a/b/c``, ``save_full_npz``),
  through :func:`unflatten_params` and ``convert.state_dict_from_jax``;
* ``.safetensors``, when the ``safetensors`` package imports;

and drops what JAX's ``convert_torch_state_dict`` drops (``loss.*``,
``model_ema.*``, FSQ's non-persistent buffers) and every key that an
``ignore_keys`` pattern ``re.match``-es.

:func:`load_into` loads such a dict into a module strictly. The
reference's torch modules may spell a key two ways that JAX's converter
maps to one leaf (``checkpoint.py:80-86``, ``:117-122``): a causal conv
wrapper's weight with or without its ``.conv`` level, a LayerNorm
wrapper's with or without ``.norm``, and a temporal conv's weight as a
Conv1d ``[O, I, k]`` or a Conv3d ``[O, I, k, 1, 1]``. Each key is matched
to the module's own spelling through that map and reshaped to it. A key
the module lacks, a module key the file lacks, or a shape that still
differs raises, naming the first few of each: JAX prints them and carries
on, which would serve a partly random model.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

from ..convert import state_dict_from_jax

# JAX's converter (vidtok_tpu/utils/checkpoint.py:33-37): a ``conv`` level
# under one of these names, and a ``norm`` level under a norm's, is dropped
_CONV_WRAPPERS = {
    "conv_in", "conv_out", "conv1", "conv2", "nin_shortcut", "conv_shortcut",
    "q", "k", "v", "proj_out", "conv",
}
_NORM_NAMES = {"norm", "norm1", "norm2", "norm_out"}
# FSQ's non-persistent buffers, dropped by name
_BUFFERS = {"_levels", "_basis", "implicit_codebook", "zero", "global_codebook_usage"}
_SHOWN = 8  # keys listed per kind when a load fails


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": array}`` -> nested ``{"a": {"b": {"c": array}}}``."""
    params: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = params
        for t in path:
            node = node.setdefault(t, {})
        node[leaf] = arr
    return params


def _read_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if any("//" in k for k in flat):  # a full checkpoint: its core section
        flat = {k[len("core//"):]: v for k, v in flat.items() if k.startswith("core//")}
    sd = state_dict_from_jax(unflatten_params(flat))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def read_state_dict(path: str, ignore_keys: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The tokenizer's weights in ``path`` as a flat state dict of CPU
    tensors in the reference's key layout (module docstring)."""
    path = str(path)
    if path.endswith(".npz"):
        sd = _read_npz(path)
    elif path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the safetensors package, "
                              "which is not installed") from e
        sd = load_file(path, device="cpu")
    else:
        obj = torch.load(path, map_location="cpu")
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: v for k, v in sd.items()
          if k.split(".")[0] not in ("loss", "model_ema")
          and k.split(".")[-1] not in _BUFFERS}
    pats = [re.compile(p) for p in ignore_keys]
    dropped = [k for k in sd if any(p.match(k) for p in pats)]
    for k in dropped:
        del sd[k]
    if dropped:
        print(f"[checkpoint] deleted {len(dropped)} keys matching ignore_keys "
              f"(first: {dropped[0]})")
    return sd


def canonical(key: str) -> str:
    """The key with the wrapper levels JAX's converter drops removed: two
    spellings of one leaf have one canonical form."""
    out = []
    for t in key.split("."):
        if out and ((t == "conv" and out[-1] in _CONV_WRAPPERS)
                    or (t == "norm" and out[-1] in _NORM_NAMES)):
            continue
        out.append(t)
    return ".".join(out)


def _fit(value: torch.Tensor, shape: torch.Size, key: str) -> torch.Tensor:
    """``value`` in the module's shape where JAX's converter would give both
    the same leaf: a Conv1d ``[O, I, k]`` and a Conv3d ``[O, I, k, 1, 1]``
    weight, a mix factor of one element."""
    if value.shape == shape:
        return value
    a, b = sorted((tuple(value.shape), tuple(shape)), key=len)
    if ((len(a) == 3 and b == a + (1, 1))
            or (key.endswith("mix_factor") and value.numel() == shape.numel() == 1)):
        return value.reshape(shape)
    return value


def load_into(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into ``module`` (``load_state_dict``, strict) after
    matching each key to the module's spelling; raises on a missing,
    unexpected or mis-shaped key (module docstring)."""
    own = module.state_dict()
    by_canon = {canonical(k): k for k in own}
    matched, unexpected, taken = {}, [], {}
    for key, value in sd.items():
        target = by_canon.get(canonical(key))
        if target is None:
            unexpected.append(key)
        elif target in taken:
            raise ValueError(f"keys {taken[target]!r} and {key!r} both give {target!r}")
        else:
            taken[target] = key
            matched[target] = _fit(value, own[target].shape, target)
    missing = [k for k in own if k not in matched]
    mismatched = [f"{k}: {tuple(v.shape)} vs {tuple(own[k].shape)}"
                  for k, v in matched.items() if v.shape != own[k].shape]
    faults = [f"{len(items)} {kind} ({', '.join(items[:_SHOWN])}"
              f"{', ...' if len(items) > _SHOWN else ''})"
              for kind, items in (("missing", missing), ("unexpected", unexpected),
                                  ("mis-shaped", mismatched)) if items]
    if faults:
        raise ValueError("checkpoint does not fit the model: " + "; ".join(faults))
    module.load_state_dict(matched, strict=True)


def load_checkpoint(module: nn.Module, path: str, ignore_keys: Iterable[str] = ()) -> None:
    """:func:`read_state_dict` of ``path`` into ``module`` by :func:`load_into`."""
    load_into(module, read_state_dict(path, ignore_keys))


def save_checkpoint(module: nn.Module, path: str) -> None:
    """``torch.save({"state_dict": ...})`` of ``module``'s CPU weights, in
    the module's (the reference's) key layout."""
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                               module.state_dict().items()}}, path)
