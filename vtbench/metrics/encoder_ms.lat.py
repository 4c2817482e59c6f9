"""encoder_ms.lat: device time of the operations launched under the program's
span ``vt.model.encoder`` (the encoder) in the traced window, each
operation joined to its launch through the trace's correlation id
(``vtbench/spans.py``), in ms per request (a stream's chunk). Nothing when
the trace holds no ``vt.*`` span."""

from vtbench import spans


def read(ctx):
    s = spans.read(ctx.traced["path"])
    n = len(ctx.traced["records"])
    return 1e3 * s.device_under("vt.model.encoder") / n if s and n else None
