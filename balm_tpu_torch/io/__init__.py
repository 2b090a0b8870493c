"""Dataset I/O of the port (counterpart: balm_tpu/io): PCD scans, pose
CSVs and the plane-cloud export, all host numpy."""
