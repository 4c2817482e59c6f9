"""YAML configs: load a file or merge several, and resolve their
``${a.b.c}`` references.

The port's own copy of ``vidtok_tpu/config.py`` (``load_config``,
``merge_configs`` and ``resolve_interpolations``), so that it imports
nothing of the JAX package. PyYAML is imported only when a path is loaded
or a dotlist value parsed; dicts need no parser.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Sequence, Union

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("loading a YAML config or parsing a dotlist value "
                          "needs PyYAML; pass resolved config dicts instead") from e
    return yaml


def _read(path_or_dict: Union[str, dict]) -> dict:
    if isinstance(path_or_dict, dict):
        return copy.deepcopy(path_or_dict)
    with open(path_or_dict) as f:
        return _yaml().safe_load(f) or {}


def load_config(path_or_dict: Union[str, dict]) -> dict:
    """A config dict (copied) or a YAML file, with references resolved."""
    return resolve_interpolations(_read(path_or_dict))


def merge_configs(*configs: Union[str, dict], dotlist: Sequence[str] = ()) -> dict:
    """Configs (paths or dicts) deep-merged left to right, then the
    ``a.b.c=value`` items of ``dotlist`` (values parsed as YAML; an item
    without ``=`` sets its key to None), then ``${...}`` references
    resolved (``vidtok_tpu/config.py:33-44``)."""
    out: dict = {}
    for c in configs:
        out = _deep_merge(out, _read(c))
    for item in dotlist:
        key, _, value = item.partition("=")
        _set_dotted(out, key.strip(), _yaml().safe_load(value))
    return resolve_interpolations(out)


def _deep_merge(base: dict, new: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (new or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    *path, leaf = dotted.split(".")
    node = cfg
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = value


def _get_dotted(cfg: dict, dotted: str) -> Any:
    node = cfg
    for k in dotted.split("."):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve whole-value ``${a.b.c}`` references against the root config,
    recursively; a cycle raises."""
    root = copy.deepcopy(cfg)

    def resolve_value(v: Any, seen: tuple) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.match(v)
            if m:
                ref = m.group(1)
                if ref in seen:
                    raise ValueError(f"Interpolation cycle at ${{{ref}}}")
                try:
                    tgt = _get_dotted(root, ref)
                except (KeyError, IndexError, TypeError):
                    raise KeyError(f"Cannot resolve interpolation ${{{ref}}}")
                return resolve_value(copy.deepcopy(tgt), seen + (ref,))
            return v
        if isinstance(v, dict):
            return {k: resolve_value(x, seen) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x, seen) for x in v]
        return v

    return resolve_value(root, ())
