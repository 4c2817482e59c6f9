"""YAML model configs: load a file and resolve its ``${a.b.c}`` references.

The port's own copy of ``vidtok_tpu/config.py`` (``load_config`` and
``resolve_interpolations``), so that it imports nothing of the JAX
package. PyYAML is imported only when a path is loaded; a resolved dict
needs no parser.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Union

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def load_config(path_or_dict: Union[str, dict]) -> dict:
    """A config dict (copied) or a YAML file, with references resolved."""
    if isinstance(path_or_dict, dict):
        cfg = copy.deepcopy(path_or_dict)
    else:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                "loading a YAML config needs PyYAML; pass a resolved config "
                "dict instead") from e
        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f) or {}
    return resolve_interpolations(cfg)


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
