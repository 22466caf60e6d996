"""EWSJF core — the paper's contribution (adaptive request-level scheduling).

A copy of the JAX package's scheduler stack and discrete-event simulator
(pure Python and NumPy).  ``CostModel`` defaults to one H100's data-sheet
peaks.

Public API:
    Request, QueueBounds, MetaParams, SchedulerPolicy, BatchPlan
    refine_and_prune, kmeans_partition, PartitionConfig
    EWSJFScheduler, FCFSScheduler, SJFScheduler, make_scheduler
    BayesianMetaOptimizer
    CostModel, ServingSimulator, WorkloadSpec
"""

from .batch_builder import BatchBudget, BatchBuilder, DEFAULT_BUCKETS
from .cost_model import CostModel, ModelCostParams, make_cost_fn
from .meta_optimizer import BayesianMetaOptimizer
from .monitor import Monitor, RewardWeights, reward, reward_terms
from .partition import (PartitionConfig, edge_divergence, kmeans_partition,
                        pooled_lengths, refine_and_prune, static_partition,
                        validate_partition, weighted_refine_and_prune)
from .queues import BubbleConfig, QueueManager, SchedulerQueue
from .scheduler import (BaseScheduler, EWSJFConfig, EWSJFScheduler,
                        FCFSScheduler, SJFScheduler, StaticPriorityScheduler,
                        make_scheduler)
from .scoring import QueueProfile, compute_score, score_decomposition, weights_for_queue
from .simulator import (EngineParams, ServingSimulator, SimResult,
                        WorkloadSpec, run_comparison, uniform_workload)
from .types import (BatchPlan, MetaParams, QueueBounds, QueueSnapshot,
                    Request, RequestState, SchedulerPolicy, SchedulerSnapshot,
                    ScoringWeights, TerminalState)

__all__ = [
    "BatchBudget", "BatchBuilder", "DEFAULT_BUCKETS",
    "CostModel", "ModelCostParams", "make_cost_fn",
    "BayesianMetaOptimizer",
    "Monitor", "RewardWeights", "reward", "reward_terms",
    "PartitionConfig", "edge_divergence", "kmeans_partition", "pooled_lengths",
    "refine_and_prune", "static_partition", "validate_partition",
    "weighted_refine_and_prune",
    "BubbleConfig", "QueueManager", "SchedulerQueue",
    "BaseScheduler", "EWSJFConfig", "EWSJFScheduler", "FCFSScheduler",
    "SJFScheduler", "StaticPriorityScheduler", "make_scheduler",
    "QueueProfile", "compute_score", "score_decomposition", "weights_for_queue",
    "EngineParams", "ServingSimulator", "SimResult", "WorkloadSpec",
    "run_comparison", "uniform_workload",
    "BatchPlan", "MetaParams", "QueueBounds", "QueueSnapshot", "Request",
    "RequestState", "SchedulerPolicy", "SchedulerSnapshot", "ScoringWeights",
    "TerminalState",
]
