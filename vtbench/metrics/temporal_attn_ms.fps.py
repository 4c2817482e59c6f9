"""temporal_attn_ms.fps: device time of the operations launched under the
program's span ``vt.model.attn.temporal`` (the temporal attention branch of
every VidTwin block: the layout copies to and from [B S, T, C], the time
embedding's add, the causal attention and the gated add) in the traced window,
each operation joined to its launch through the trace's correlation id
(``vtbench/spans.py``), in ms per input frame of the requests the window ran.
Nothing when the trace holds no ``vt.*`` span."""

from vtbench import spans


def read(ctx):
    s = spans.read(ctx.traced["path"])
    frames = sum(r.frames for r in ctx.traced["records"])
    return 1e3 * s.device_under("vt.model.attn.temporal") / frames if s and frames else None
