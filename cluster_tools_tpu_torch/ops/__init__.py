"""Ops: label primitives, the four tile kernels and their twins, EDT, tiled CCL and watershed, the RAG,
the contraction engine and the multicut and agglomeration solvers."""
