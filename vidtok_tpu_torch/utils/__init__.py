"""Checkpoint files (``checkpoint.py``)."""
