"""Certified serving: concurrent requests coalesced onto the pad ladder
of a certified, warmed fitted pipeline.

Counterpart of `keystone_tpu/serving/__init__.py`. `ServingRuntime`
certifies a fitted pipeline (`analysis/serving.py`, KP901–KP906), warms
every ladder rung before traffic (on the card: each rung's CUDA graph
captured), and serves: `MicroBatcher` coalesces concurrent single
requests into one stacked dispatch, a full queue sheds
(``KEYSTONE_SERVING_QUEUE_DEPTH``), ``KEYSTONE_SERVING_COALESCE=0``
applies each request on its caller's thread, and `swap` replaces the
pipeline with no request lost. `TenantRegistry` admits runtimes against
the device memory budget (KP905); `NdarrayIngress` and `TextIngress`
(with `split_fitted_at`) hold requests to the certified element.
Requests and answers are host numpy arrays.
"""

from .batcher import MicroBatcher, ShedError
from .ingress import IngressError, NdarrayIngress, TextIngress, split_fitted_at
from .registry import AdmissionRefused, TenantRegistry
from .runtime import CertificationError, ServingRuntime

__all__ = [
    "AdmissionRefused",
    "CertificationError",
    "IngressError",
    "MicroBatcher",
    "NdarrayIngress",
    "ServingRuntime",
    "ShedError",
    "TenantRegistry",
    "TextIngress",
    "split_fitted_at",
]
