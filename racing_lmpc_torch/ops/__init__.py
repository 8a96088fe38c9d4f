"""Math core of the port: the counterpart of ``racing_lmpc_tpu.ops``."""
