"""The VidTok GAN training stack (``vidtok_tpu/train``)."""
