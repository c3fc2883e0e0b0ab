"""End-to-end pipelines (counterpart of `keystone_tpu/pipelines`)."""
