"""Pair-major layout and the batch primitives of compression and recompression."""
