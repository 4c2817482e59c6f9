"""Multi-process data parallelism over ``torch.distributed``."""
