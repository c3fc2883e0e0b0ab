"""Pipeline nodes (counterpart of `keystone_tpu/nodes`)."""
