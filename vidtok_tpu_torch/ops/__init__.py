"""Device operations: the hand-written kernels and their plain forms."""
