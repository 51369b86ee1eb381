from cudasbmp_torch.ops.compaction import compact_indices
from cudasbmp_torch.ops.rollout import propagate_and_check, rollout_batch, rollout_unchecked
from cudasbmp_torch.ops.segments import masked_bincount, masked_multi_bincount, scatter_or

__all__ = ["rollout_batch", "rollout_unchecked", "propagate_and_check",
           "compact_indices", "masked_bincount", "masked_multi_bincount", "scatter_or"]
