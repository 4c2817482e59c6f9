"""device_idle: the share of the traced window in which no operation ran
on the device (%): 1 - the union of the device's operation intervals over
the window's length."""


def read(ctx):
    s = ctx.traced["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
