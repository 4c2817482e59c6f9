"""kernel_roofline: the port's kernels' share of their roofline in the
traced window (%): the least time their calls need (each call the larger
of its bytes over the HBM rate and its FLOP over the peak rate, from the
frozen work and call counters, for every request the traced window ran)
over the device time of the kernels the kernel-name patterns attribute
to the port. Nothing when no port kernel ran."""


def read(ctx):
    s = ctx.traced["summary"]
    if s["port_kernel_s"] <= 0:
        return None
    least = sum(ctx.work[r.kind][0] for r in ctx.traced["records"])
    return 100.0 * least / s["port_kernel_s"]
