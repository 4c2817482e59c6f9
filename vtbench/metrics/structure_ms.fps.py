"""structure_ms.fps: device time of the operations launched under the program's
span ``vt.model.structure`` (VidTwin's structure pathway: the Q-Former over
each position's frames and the conv pyramid down to u_S, and back up with the
token mix) in the traced window, each operation joined to its launch through
the trace's correlation id (``vtbench/spans.py``), in ms per input frame of
the requests the window ran. Nothing when the trace holds no ``vt.*`` span."""

from vtbench import spans


def read(ctx):
    s = spans.read(ctx.traced["path"])
    frames = sum(r.frames for r in ctx.traced["records"])
    return 1e3 * s.device_under("vt.model.structure") / frames if s and frames else None
