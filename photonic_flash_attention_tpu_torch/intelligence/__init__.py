"""Intelligence: workload pattern learning + bandit kernel selection."""

from .adaptive_learning import (
    AdaptiveDecisionEngine,
    Outcome,
    UCB1Bandit,
    WorkloadPatternAnalyzer,
    workload_features,
)

__all__ = [
    "AdaptiveDecisionEngine",
    "Outcome",
    "UCB1Bandit",
    "WorkloadPatternAnalyzer",
    "workload_features",
]
