"""Sparse-matrix generators (counterpart of ``repro.data.matrices``)."""
