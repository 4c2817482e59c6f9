"""operand_rebuild: the kernel wrappers' operand relayouts built because no
cached one was served, per wrapper call (%): 100 x the sum of the
wrappers' ``builds`` over the sum of their ``calls``, as the counters hold
them when read (both windows, since the harness's ``reset_counts()`` after
the warm-up). 0 when every call found its weights laid out. Nothing when
the program keeps no ``builds`` counter or no wrapper was called."""


def read(ctx):
    from vidtok_tpu_torch.ops import kernels as K

    try:
        builds = sum(K.counts("builds").values())
    except AttributeError:  # a program without the counter
        return None
    calls = sum(K.counts("calls").values())
    return 100.0 * builds / calls if calls else None
