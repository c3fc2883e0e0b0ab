"""Workflow core: the lazy memoized DAG runtime, its optimizer and the
typed combinator API (counterpart of `keystone_tpu/workflow`)."""

from . import analysis
from .autocache import AutoCacheRule, CacheMarker
from .env import (
    ExecutionConfig,
    IdentityKey,
    PipelineEnv,
    Prefix,
    compute_prefix,
    config_override,
    dispatch_override,
    execution_config,
    overlap_override,
    set_execution_config,
)
from .executor import GraphExecutor, drain_warmups
from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    StreamingDatasetExpression,
    TransformerExpression,
)
from .fusion_rule import (
    FusedChainOperator,
    MegafusedPlanOperator,
    MegafusionRule,
    NodeFusionRule,
)
from .graph import Graph, NodeId, NodeOrSourceId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    GatherTransformerOperator,
    Operator,
    TransformerOperator,
)
from .optimizer import (
    AutoCachingOptimizer,
    Batch,
    DefaultOptimizer,
    EquivalentNodeMergeRule,
    ExtractSaveablePrefixes,
    NodeOptimizationRule,
    Optimizer,
    Rule,
    RuleExecutor,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
)
from .pipeline import (
    Chainable,
    Estimator,
    EstimatorChain,
    FittedPipeline,
    ItemTransformer,
    LabelEstimator,
    LabelEstimatorChain,
    OptimizableEstimator,
    OptimizableLabelEstimator,
    OptimizableTransformer,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineResult,
    Transformer,
    TransformerChain,
)

__all__ = [n for n in dir() if not n.startswith("_")]
