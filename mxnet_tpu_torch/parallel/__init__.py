"""Parallel attention helpers of the port (mirrors ``mxnet_tpu/parallel``).

Only the single-device attention dispatcher is ported so far; the mesh
toolkit, the ring and Ulysses sequence parallelism, pipeline and MoE
wait for ROADMAP Queue 1 item 10."""
