"""The explicit cache of a causal stream, for chunked (tiled) inference.

A causal module that sees a clip chunk by chunk carries a few frames of
its input from one chunk to the next (``vidtok_tpu`` keeps them in flax's
``'cache'`` collection). Here that state is a plain dict, ``{module path:
tensor}``, that a chunk step receives and returns: a :class:`Stream` reads
the dict it was given (``cache``, never written) and collects the dict
this step leaves for the next (``new``). The modules hold no state, so S
streams batched along B carry S rows in every entry and cannot leak into
each other. Every copy that reads or writes a cache (its casts, ``cat``s
and ``clone``s) runs under the span ``vt.stream.cache``; kernel F reads
and writes its caches itself.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.profiling import span


class Stream:
    """One chunk step over the modules under ``root``.

    ``first_chunk`` starts the stream: a causal front repeats the chunk's
    frame 0 (whatever ``first_pad_mode`` says) and nothing is read.
    ``use_cache_offset`` stores each module's cache ``module.cache_offset``
    frames back, as if the chunk's trailing look-ahead frames had not been
    seen (overlap-tiled decode).
    """

    def __init__(self, root: nn.Module, cache: Optional[dict] = None,
                 first_chunk: bool = True, use_cache_offset: bool = False):
        if cache is None and not first_chunk:
            raise ValueError("a chunk after the first needs the previous "
                             "chunk's cache")
        self.cache = {} if cache is None else cache
        self.new = {}
        self.first_chunk = first_chunk
        self.use_cache_offset = use_cache_offset
        self._paths = {m: name for name, m in root.named_modules()}

    def get(self, module: nn.Module):
        """What ``module`` left in the previous chunk's step."""
        return self.cache[self._paths[module]]

    def put(self, module: nn.Module, value) -> None:
        self.new[self._paths[module]] = value

    def offset(self, module: nn.Module) -> int:
        return module.cache_offset if self.use_cache_offset else 0

    def front(self, module: nn.Module, x, n: int):
        """``[n front frames | x]`` for a causal conv with ``n`` frames of
        time padding; the front is the cached tail of the previous chunk's
        ``[front | x]``, or frame 0 repeated on the first chunk. Caches
        ``full[L-off-n : L-off]`` (L = n + chunk length)."""
        with span("vt.stream.cache"):
            if self.first_chunk:
                head = x[:, :1].expand(-1, n, *x.shape[2:])
            else:
                head = self.get(module).to(x.dtype)
            full = torch.cat([head, x], dim=1)
            self.put(module, tail(full, n, self.offset(module)))
            return full

    def keep_tail(self, module: nn.Module, full, n: int) -> None:
        """Cache ``full``'s tail as :meth:`front` does, for a caller that
        built ``[n front frames | x]`` itself."""
        with span("vt.stream.cache"):
            self.put(module, tail(full, n, self.offset(module)))


def tail(full, n: int, off: int):
    """``full[:, L-off-n : L-off]`` as a tensor of its own (a view would keep
    the whole chunk alive); raises when the chunk is shorter than ``off``."""
    end = full.shape[1] - off
    if end - n < 0:
        raise ValueError(f"cache offset {off} reaches before the chunk start "
                         f"({full.shape[1]} frames with the front)")
    return full[:, end - n:end].clone()
