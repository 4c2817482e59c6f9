"""conv_tiles_per_block: the output tiles each block of the wgmma conv loop
walks (kernels A, B, E, F), over the window: the sum of the kernel
wrappers' ``conv_tiles`` over the sum of their ``conv_blocks``, as the
counters hold them when read (both windows, since the harness's
``reset_counts()`` after the warm-up). 1.0 when every block takes one
tile; above 1 where the persistent loop walks several. Nothing when the
program keeps no such counter or launched no conv."""


def read(ctx):
    from vidtok_tpu_torch.ops import kernels as K

    try:
        tiles = sum(K.counts("conv_tiles").values())
        blocks = sum(K.counts("conv_blocks").values())
    except AttributeError:  # a program without the counters
        return None
    return tiles / blocks if blocks else None
