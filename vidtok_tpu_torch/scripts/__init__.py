"""The port's serving CLIs (``scripts/`` of the JAX package), each run as
``python -m vidtok_tpu_torch.scripts.<name>``: ``inference_evaluate``
(PSNR, SSIM and LPIPS over a directory of videos), ``inference_reconstruct``
(a video and its reconstruction side by side) and ``stream_tokens`` (the
causal encoder chunk by chunk). Each takes the JAX script's flags, plus
``--device`` (default ``cuda``) and ``--full_pickle``, and keeps its
compute in a function that takes a tokenizer and frames on the device."""
