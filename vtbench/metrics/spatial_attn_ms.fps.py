"""spatial_attn_ms.fps: device time of the operations launched under the
program's span ``vt.model.attn.spatial`` (the spatial attention branch of
every VidTwin block, from its first norm through its gated add) in the traced
window, each operation joined to its launch through the trace's correlation id
(``vtbench/spans.py``), in ms per input frame of the requests the window ran.
Nothing when the trace holds no ``vt.*`` span."""

from vtbench import spans


def read(ctx):
    s = spans.read(ctx.traced["path"])
    frames = sum(r.frames for r in ctx.traced["records"])
    return 1e3 * s.device_under("vt.model.attn.spatial") / frames if s and frames else None
