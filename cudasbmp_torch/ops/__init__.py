from cudasbmp_torch.ops.rollout import rollout_batch, rollout_unchecked

__all__ = ["rollout_batch", "rollout_unchecked"]
