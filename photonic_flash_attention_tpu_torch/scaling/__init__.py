"""Scaling: cluster task scheduling, request load balancing, autoscaling."""

from .autoscaler import AutoScalingOrchestrator, MetricSample, ScalingDecision
from .load_balancer import BackendNode, ConsistentHashRing, LoadBalancer
from .workload_balancer import (
    ComputeNode,
    DistributedTask,
    DistributedWorkloadBalancer,
    PlacementStrategy,
    TaskState,
)

__all__ = [
    "AutoScalingOrchestrator",
    "BackendNode",
    "ComputeNode",
    "ConsistentHashRing",
    "DistributedTask",
    "DistributedWorkloadBalancer",
    "LoadBalancer",
    "MetricSample",
    "PlacementStrategy",
    "ScalingDecision",
    "TaskState",
]
