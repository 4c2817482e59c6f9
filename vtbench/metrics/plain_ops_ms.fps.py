"""plain_ops_ms.fps: device time of every operation that is not a port
kernel (cuDNN convs, SDPA, elementwise, copies) in the traced window, in
ms per input frame of the requests it ran."""


def read(ctx):
    frames = sum(r.frames for r in ctx.traced["records"])
    return 1e3 * ctx.traced["summary"]["plain_s"] / frames if frames else None
