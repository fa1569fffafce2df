"""Gram-matrix hot ops: the plain-XLA Gram build (ops/gram.py) and the
matrix-free streamed products (ops/matvec.py)."""

from gp_ss_ak_tpu.ops.gram import expans_bias_gram, mapped_points

__all__ = ["expans_bias_gram", "mapped_points"]
