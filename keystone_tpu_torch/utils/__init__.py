"""Utilities (counterpart of `keystone_tpu/utils`)."""
