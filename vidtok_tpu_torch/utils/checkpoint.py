"""Checkpoint files in and out of the port (the load half of
``vidtok_tpu/utils/checkpoint.py``, ``:209-300``, and its torch writer).

:func:`read_state_dict` reads a flat state dict from

* a torch file (``.ckpt`` / ``.pt``, anything not named below):
  ``torch.load`` on the CPU, its ``["state_dict"]`` when it has one.
  The load is weights-only (tensors and plain containers) unless the
  caller passes ``full_pickle=True``: a Lightning ``.ckpt`` whose other
  entries hold objects (a ``np.float64`` in ``callbacks``, an
  ``argparse.Namespace`` in ``hyper_parameters``) needs the full pickle,
  which runs code from the file, as JAX's reader always does
  (``weights_only=False``);
* JAX's ``.npz``: ``save_params``' flat ``a/b/c`` keys, or the ``core``
  section of a full-checkpoint npz (``core//a/b/c``, ``save_full_npz``),
  through :func:`unflatten_params` and ``convert.state_dict_from_jax``;
* ``.safetensors``, when the ``safetensors`` package imports;

and drops what JAX's ``convert_torch_state_dict`` drops (``loss.*``,
``model_ema.*``, FSQ's non-persistent buffers) and every key that an
``ignore_keys`` pattern ``re.match``-es.

:func:`read_vidtwin_state_dict` reads a VidTwin model's weights from the
same three sources (the ``.npz`` through ``vidtwin_state_dict_from_jax``)
and drops what JAX's ``convert_vidtwin_state_dict`` drops.

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

The train-state half (``checkpoint.py:385-485``): :func:`save_train_state`
writes one ``torch.save`` file a step, ``step_XXXXXXXX.pt`` (the trainer's
:meth:`~..train.trainer.VidTokTrainer.state_dict`: core, ``logvar``, the
discriminator with its buffers, both optimizers, the EMA, LeCAM's EMAs,
the step and the RNG states), keeps the newest ``keep``, or, once a
checkpoint carries a monitor value (``monitor.json``), the best ``keep``
by it and the newest; :func:`restore_train_state` reads one weights-only.
orbax's directories, JAX's format, are not read.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import state_dict_from_jax
from ..models.vidtwin.convert import DROPPED as VIDTWIN_DROPPED
from ..models.vidtwin.convert import (vidtwin_ablation_state_dict_from_jax,
                                      vidtwin_state_dict_from_jax)

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


def _read_npz(path: str, from_jax=state_dict_from_jax) -> Dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if any("//" in k for k in flat):  # a full checkpoint: its core section
        flat = {k[len("core//"):]: v for k, v in flat.items() if k.startswith("core//")}
    sd = from_jax(unflatten_params(flat))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def read_torch_file(path: str, full_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """Every entry of a torch (``.ckpt`` / ``.pt``) or ``.safetensors``
    file's state dict, ``loss.*`` and ``model_ema.*`` included, as CPU
    tensors. A torch file that a weights-only load refuses raises, naming
    ``full_pickle``."""
    path = str(path)
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the safetensors package, "
                              "which is not installed") from e
        return load_file(path, device="cpu")
    try:
        obj = torch.load(path, map_location="cpu", weights_only=not full_pickle)
    except pickle.UnpicklingError as e:
        if full_pickle:
            raise
        raise pickle.UnpicklingError(
            f"{path}: a weights-only load refused this file, which holds "
            "more than tensors. If you trust it, load its full pickle "
            "(it runs code from the file): full_pickle=True, or "
            "--full_pickle on the command line.") from e
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


def read_state_dict(path: str, ignore_keys: Iterable[str] = (),
                    full_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """The tokenizer's weights in ``path`` as a flat state dict of CPU
    tensors in the reference's key layout (module docstring). A torch file
    that a weights-only load refuses raises, naming ``full_pickle``."""
    path = str(path)
    sd = _read_npz(path) if path.endswith(".npz") else read_torch_file(path, full_pickle)
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


def read_vidtwin_state_dict(path: str, full_pickle: bool = False,
                            ablation: bool = False) -> Dict[str, torch.Tensor]:
    """A VidTwin model's weights in ``path`` in the reference's key layout:
    a torch or ``.safetensors`` file less the keys JAX's converter drops
    (``models.vidtwin.convert.DROPPED``), or JAX's ``.npz`` through
    ``vidtwin_state_dict_from_jax`` (``vidtwin_ablation_state_dict_from_jax``
    for an ``ablation`` model; the same three sources as JAX's
    ``VidTwinTokenizer.from_config``)."""
    path = str(path)
    if path.endswith(".npz"):
        return _read_npz(path, vidtwin_ablation_state_dict_from_jax if ablation
                         else vidtwin_state_dict_from_jax)
    return {k: v for k, v in read_torch_file(path, full_pickle).items()
            if not VIDTWIN_DROPPED.search(k)}


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


def load_into(module: nn.Module, sd: Dict[str, torch.Tensor],
              keep: Iterable[str] = ()) -> None:
    """Copy ``sd`` into ``module`` (``load_state_dict``) after matching each
    key to the module's spelling; raises on a missing, unexpected or
    mis-shaped key (module docstring). A module key that a ``keep``
    pattern ``re.match``-es may be absent: it keeps its weights."""
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
    kept = [re.compile(p) for p in keep]
    missing = [k for k in own if k not in matched and not any(p.match(k) for p in kept)]
    mismatched = [f"{k}: {tuple(v.shape)} vs {tuple(own[k].shape)}"
                  for k, v in matched.items() if v.shape != own[k].shape]
    faults = [f"{len(items)} {kind} ({', '.join(items[:_SHOWN])}"
              f"{', ...' if len(items) > _SHOWN else ''})"
              for kind, items in (("missing", missing), ("unexpected", unexpected),
                                  ("mis-shaped", mismatched)) if items]
    if faults:
        raise ValueError("checkpoint does not fit the model: " + "; ".join(faults))
    module.load_state_dict(matched, strict=not kept)


def load_checkpoint(module: nn.Module, path: str, ignore_keys: Iterable[str] = (),
                    full_pickle: bool = False, keep_ignored: bool = False) -> None:
    """:func:`read_state_dict` of ``path`` into ``module`` by :func:`load_into`.
    With ``keep_ignored`` (fine-tuning, as the reference's ``init_from_ckpt``
    and JAX's trainer do) the keys ``ignore_keys`` drops keep the module's
    weights; without it they are missing and raise."""
    load_into(module, read_state_dict(path, ignore_keys, full_pickle),
              ignore_keys if keep_ignored else ())


def save_checkpoint(module: nn.Module, path: str) -> None:
    """``torch.save({"state_dict": ...})`` of ``module``'s CPU weights, in
    the module's (the reference's) key layout."""
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                               module.state_dict().items()}}, path)


# ---------------------------------------------------------------------------
# train state


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pt"))


def _ledger_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "monitor.json")


def load_monitor_ledger(ckpt_dir: str) -> Dict[int, float]:
    """step -> monitor value of the checkpoints saved with one."""
    p = _ledger_path(ckpt_dir)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return {int(k): float(v) for k, v in json.load(f).items()}


def all_checkpoint_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in (re.match(r"step_(\d+)\.pt$", n)
                                      for n in os.listdir(ckpt_dir)) if m]


def save_train_state(ckpt_dir: str, trainer, step: int, keep: int = 3,
                     monitor_value: Optional[float] = None) -> str:
    """Write ``trainer``'s state as step ``step`` and prune: the best
    ``keep`` by monitor (lower is better) plus the newest once any
    checkpoint has a monitor value, else the newest ``keep`` (Lightning's
    ``ModelCheckpoint(save_top_k=keep, mode='min', save_last=True)``).
    Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)
    ledger = load_monitor_ledger(ckpt_dir)
    if monitor_value is not None:
        ledger[step] = float(monitor_value)
    steps = sorted(all_checkpoint_steps(ckpt_dir))
    if ledger:
        ranked = sorted((s for s in steps if s in ledger), key=lambda s: (ledger[s], -s))
        kept = set(ranked[:keep]) | {max(steps)}
    else:
        kept = set(steps[-keep:])
    for s in steps:
        if s not in kept:
            os.remove(_step_path(ckpt_dir, s))
            ledger.pop(s, None)
    if ledger:
        with open(_ledger_path(ckpt_dir), "w") as f:
            json.dump({str(k): v for k, v in sorted(ledger.items())}, f)
    return path


def latest_checkpoint(ckpt_dir: str) -> Tuple[Optional[str], Optional[int]]:
    """(path, step) of the newest checkpoint, or (None, None)."""
    steps = all_checkpoint_steps(ckpt_dir)
    if not steps:
        return None, None
    return _step_path(ckpt_dir, max(steps)), max(steps)


def best_checkpoint(ckpt_dir: str) -> Tuple[Optional[str], Optional[int]]:
    """(path, step) of the best checkpoint by monitor, or (None, None)."""
    ledger = load_monitor_ledger(ckpt_dir)
    steps = set(all_checkpoint_steps(ckpt_dir))
    avail = [s for s in ledger if s in steps]
    if not avail:
        return None, None
    s = min(avail, key=lambda s: (ledger[s], -s))
    return _step_path(ckpt_dir, s), s


def restore_train_state(path: str, trainer) -> int:
    """Load a :func:`save_train_state` file (weights-only) into ``trainer``;
    returns the restored step."""
    trainer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return trainer.step
