"""kernel_host_us.lat: the mean host duration of the program's
``vt.kernel.*`` spans under which a device operation was launched in the
traced window (``vtbench/spans.py``): the kernel wrappers' own host cost
per kernel call, from entry to return (plan, operands, tensor maps,
allocation, launch), in us. Nothing when the trace holds no such span."""

from vtbench import spans


def read(ctx):
    s = spans.read(ctx.traced["path"])
    us = [p.end - p.start for p in (s.spans if s else ()) if p.name.startswith("vt.kernel.")
          and p.ops]
    return sum(us) / len(us) if us else None
