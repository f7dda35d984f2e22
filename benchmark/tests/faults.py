"""Broken stand-ins for functions of the program, named by a test mix's
``fault`` so that they reach the ranks of a mesh."""

from __future__ import annotations


def reduce_scatter_left_out(self, t, part):
    """``Mesh.reduce_scatter`` without the exchange: each rank keeps its own
    partial sums."""
    t = t.contiguous()
    return t if part is None else t[part].contiguous()
