"""Well-known env names and ports of the slice's pod contract (a copy of
the values the port needs from ``kuberay_tpu/utils/constants.py``)."""

# Identity within the slice, injected by the operator's pod builder.
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
# Multi-slice coordination.
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
# The head's coordinator address (host:port) and the process count.
ENV_COORDINATOR_ADDRESS = "TPU_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPU_NUM_PROCESSES"

PORT_DASHBOARD = 8265           # runtime dashboard / job API
PORT_METRICS = 8080             # Prometheus metrics on every node
PORT_SERVE = 8000               # inference HTTP
PORT_MXLA = 8081                # multi-process coordinator on worker 0
PORT_GROUP_HEALTH = 8090        # serve-group heartbeat listener (rank 0)
