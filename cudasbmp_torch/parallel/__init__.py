from cudasbmp_torch.parallel.batch_kgmt import ArenaMultiQueryPlanner
from cudasbmp_torch.parallel.mesh import (
    device_count,
    make_planner_mesh,
    maybe_initialize_distributed,
)
from cudasbmp_torch.parallel.monte_carlo import MonteCarloPlanner, random_scenarios
from cudasbmp_torch.parallel.multi_query import (
    MultiQueryPlanner,
    MultiQueryResult,
    stack_scenarios,
)
from cudasbmp_torch.parallel.sharded_multi_query import (
    ShardedMultiQueryPlanner,
    ShardedMultiQueryResult,
)
from cudasbmp_torch.parallel.sharded_tree import ShardedTreePlanner, ShardedTreeResult
from cudasbmp_torch.parallel.streaming_mc import StreamingMonteCarloPlanner

__all__ = [
    "ArenaMultiQueryPlanner",
    "MonteCarloPlanner",
    "MultiQueryPlanner",
    "MultiQueryResult",
    "ShardedMultiQueryPlanner",
    "ShardedMultiQueryResult",
    "ShardedTreePlanner",
    "ShardedTreeResult",
    "StreamingMonteCarloPlanner",
    "device_count",
    "make_planner_mesh",
    "maybe_initialize_distributed",
    "random_scenarios",
    "stack_scenarios",
]
