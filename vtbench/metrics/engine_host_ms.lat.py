"""engine_host_ms.lat: the median host time of the program's call, from
issue until it returns, before the benchmark waits for the device (ms a
request, the untraced window). It shows the enqueue and any synchronize
hidden inside the call."""

import statistics


def read(ctx):
    times = [(r.returned - r.issued) * 1e3 for r in ctx.window.records]
    return statistics.median(times) if times else None
