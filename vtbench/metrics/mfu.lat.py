"""mfu: the whole step's share of the chip's peak (%): the model function's
FLOP (the frozen reference counted on the meta device) for every request
the untraced window completed, over the window's seconds times the dense
bf16 peak of one H100 (989 TFLOP/s)."""

from vtbench.reference.work import PEAKS


def read(ctx):
    flops = sum(ctx.work[r.kind][1] for r in ctx.window.records)
    return 100.0 * flops / (ctx.window.seconds * PEAKS["bf16_tensor_flops"])
