"""Sparse-matrix generators (counterpart of ``repro.data.matrices``) and the
token pipeline (``repro.data.pipeline``)."""
