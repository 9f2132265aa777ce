"""File I/O: the GSD container and the frame store on it (counterparts
of hoomd_tpu/io/gsd_binary.py and frames.py)."""
