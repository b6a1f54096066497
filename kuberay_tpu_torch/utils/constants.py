"""Well-known ports the serving surface binds (copy of the values the port
needs from ``kuberay_tpu/utils/constants.py``)."""

PORT_SERVE = 8000               # inference HTTP
