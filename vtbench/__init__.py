"""The benchmark of ``vidtok_tpu_torch`` on one NVIDIA H100 (``run.py``;
README.md)."""
