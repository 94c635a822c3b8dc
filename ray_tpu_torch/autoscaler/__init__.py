"""Autoscaler: resize the cluster to match queued resource demand.

Reference: ``python/ray/autoscaler/_private/autoscaler.py:171``
(StandardAutoscaler) + ``resource_demand_scheduler.py:102`` (bin-pack
demand onto node types) + ``fake_multi_node/node_provider.py:237``
(cloudless provider for tests).
"""

from .autoscaler import AutoscalerConfig, NodeType, StandardAutoscaler  # noqa: F401
from .node_provider import FakeNodeProvider, NodeProvider  # noqa: F401
