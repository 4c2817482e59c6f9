"""plain_ops_ms.lat: device time of every operation that is not a port
kernel (cuDNN convs, SDPA, elementwise, copies) in the traced window, in
ms per request."""


def read(ctx):
    n = len(ctx.traced["records"])
    return 1e3 * ctx.traced["summary"]["plain_s"] / n if n else None
