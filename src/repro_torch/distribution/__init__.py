"""Batch primitives shared by the compression entry points."""
