"""Core: cache-aware GEMM configuration and asymmetric scheduling, for Hopper."""

from repro_torch.core.blocking import (
    BlockConfig,
    CacheHierarchy,
    GotoBlocking,
    HopperClassSpec,
    derive_block_config,
    derive_goto_blocking,
)
from repro_torch.core.control_tree import ControlTree, build_control_trees
from repro_torch.core.execution import (
    ExecutionContext,
    context_for_tree,
    current_context,
    default_context,
)
from repro_torch.core.schedule import (
    ChunkTable,
    DynamicScheduler,
    ca_sas_partition,
    das_schedule,
    sas_partition,
    sss_partition,
)
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass

__all__ = [
    "BlockConfig", "CacheHierarchy", "GotoBlocking", "HopperClassSpec",
    "derive_block_config", "derive_goto_blocking",
    "ControlTree", "build_control_trees",
    "ExecutionContext", "context_for_tree", "current_context", "default_context",
    "ChunkTable", "DynamicScheduler",
    "ca_sas_partition", "das_schedule", "sas_partition", "sss_partition",
    "AsymmetricMesh", "DeviceClass",
]
