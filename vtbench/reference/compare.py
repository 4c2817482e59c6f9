"""Measures by which a reference module compares the program's answers with
its own: shared by every reference module."""

from __future__ import annotations


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64; inf where shapes differ or a is not
    finite."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    a, b = a.double(), b.double()
    d = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return d if d == d else float("inf")


def output_rel_l2(k: int):
    """The number that reads output ``k`` of an answer: its relative L2
    against the reference's output ``k``; inf where either lacks it."""
    def number(got, want) -> float:
        if len(got) <= k or len(want) <= k:
            return float("inf")
        return rel_l2(got[k], want[k])
    return number
