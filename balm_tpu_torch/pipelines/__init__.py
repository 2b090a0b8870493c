"""End-to-end experiments of the port (counterpart: balm_tpu/pipelines)."""
