"""Tokenizer models."""
