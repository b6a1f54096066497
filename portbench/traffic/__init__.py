"""Traffic mixes: one data file each, read by ``generate.py``."""
