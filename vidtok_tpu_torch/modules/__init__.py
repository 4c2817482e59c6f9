"""Model building blocks on channels-last ``[B, T, H, W, C]`` tensors."""
