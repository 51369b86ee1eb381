from cudasbmp_torch.ops.rollout import rollout_batch

__all__ = ["rollout_batch"]
