"""The benchmark's yardstick. Each configuration names its reference
module here (``causal_kl`` for VidTok's causal KL tokenizers): the plain
float32 model and its control, its seeded weights, its answers, its frozen
kernel calls and FLOP. Shared by every module: the seeds and clips
(``weights``), each kernel's work, the chip's peaks and the engine's chunks
(``work``), the measures answers are compared by (``compare``). Nothing
here imports the program it judges."""
