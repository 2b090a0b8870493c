"""Scanline feature extractors (counterpart: balm_tpu/features)."""
