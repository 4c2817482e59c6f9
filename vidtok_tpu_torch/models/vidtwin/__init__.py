"""VidTwin (``vidtok_tpu/models/vidtwin``): the space-time transformer, the
Q-Former, the structure/dynamics VAE, its ablation ladder (``ablations``),
their weights from JAX, and (in ``engine``, ``schedules``, ``trainer``) the
serving engine, learning-rate schedules and GAN trainer."""

from .qformer import QFormerInterface
from .st_transformer import STTDecoder, STTEncoder
from .vidtwin_ae import VidTwinVAE, build_vidtwin_from_config

__all__ = ["STTEncoder", "STTDecoder", "QFormerInterface", "VidTwinVAE",
           "build_vidtwin_from_config"]
