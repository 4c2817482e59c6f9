"""Config-driven construction (``vidtok_tpu/registry.py``; reference
vidtok/modules/util.py:69-86): a config's ``target:`` / ``params:`` name a
class, by a name a user registered (``@register()``), by a registered
name of this package or the reference's dotted path (so the repo's YAML
configs resolve unchanged), else by a dotted import path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

# name -> class: the user's ``@register`` classes and the built-ins
# ``resolve`` has imported
_REGISTRY: Dict[str, Any] = {}

# the reference's dotted targets -> registered names
_ALIASES = {
    "vidtok.modules.regularizers.DiagonalGaussianRegularizer": "DiagonalGaussianRegularizer",
    "vidtok.modules.regularizers.FSQRegularizer": "FSQRegularizer",
    "vidtok.data.datamodule.DataModuleFromConfig": "DataModuleFromConfig",
    "vidtok.data.vidtok.VidTokDataset": "VidTokDataset",
    "vidtok.data.vidtok.VidTokValDataset": "VidTokValDataset",
    "vidtok.modules.logger.ImageVideoLogger": "ImageVideoLogger",
    "vidtwin.models.vidtwin_ae.VidAutoEncoderQformerCompactSymVidVAE": "VidTwinVAE",
    "vidtwin.modules.st_transformer.STTEncoder": "STTEncoder",
    "vidtwin.modules.st_transformer.STTDecoder": "STTDecoder",
    "vidtwin.modules.qformer.MyQformerInterface": "QFormerInterface",
}

# registered name -> the module of this package that defines it
_LAZY = {
    "VidTokDataset": "vidtok_tpu_torch.data.dataset",
    "VidTokValDataset": "vidtok_tpu_torch.data.dataset",
    "DataModuleFromConfig": "vidtok_tpu_torch.data.datamodule",
    "ImageVideoLogger": "vidtok_tpu_torch.utils.logging",
    "Encoder": "vidtok_tpu_torch.modules.encoder",
    "Decoder": "vidtok_tpu_torch.modules.decoder",
    "DiagonalGaussianRegularizer": "vidtok_tpu_torch.modules.regularizers",
    "FSQRegularizer": "vidtok_tpu_torch.modules.regularizers",
    "NLayerDiscriminator": "vidtok_tpu_torch.modules.discriminator",
    "NLayerDiscriminator3D": "vidtok_tpu_torch.modules.discriminator",
    "LPIPS": "vidtok_tpu_torch.modules.lpips",
    "VidTwinVAE": "vidtok_tpu_torch.models.vidtwin.vidtwin_ae",
    "STTEncoder": "vidtok_tpu_torch.models.vidtwin.st_transformer",
    "STTDecoder": "vidtok_tpu_torch.models.vidtwin.st_transformer",
    "QFormerInterface": "vidtok_tpu_torch.models.vidtwin.qformer",
}


def register(name: str = None) -> Callable:
    """Class decorator, ``@register()`` or ``@register("Name")``: a config's
    ``target: Name`` (the class's own name by default) then builds it."""

    def deco(cls):
        _REGISTRY[name or cls.__name__] = cls
        return cls

    return deco


def resolve(target: str) -> Any:
    """The class a ``target:`` string names: a registered one, else a
    built-in (then registered), else a dotted import."""
    target = _ALIASES.get(target, target)
    if target in _REGISTRY:
        return _REGISTRY[target]
    if target in _LAZY:
        _REGISTRY[target] = getattr(importlib.import_module(_LAZY[target]), target)
        return _REGISTRY[target]
    if "." in target:
        return get_obj_from_str(target)
    raise KeyError(f"unknown target {target!r}; registered: "
                   f"{sorted(set(_REGISTRY) | set(_LAZY))}")


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """``pkg.mod.Obj`` by import (reference util.py:79-86)."""
    module, name = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, name)


def instantiate_from_config(config: dict, **extra_kwargs) -> Any:
    """``resolve(config["target"])(**config["params"], **extra_kwargs)``."""
    if "target" not in config:
        raise KeyError(f"expected a 'target' key, got {list(config)}")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return resolve(config["target"])(**params)


def registered() -> Dict[str, Any]:
    """A copy of the registry: the registered names and their classes."""
    return dict(_REGISTRY)
