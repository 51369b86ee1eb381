from cudasbmp_torch.io.checkpoint import load_checkpoint, save_checkpoint
from cudasbmp_torch.io.csv import (
    load_scenario,
    read_obstacles_csv,
    read_sample_csv,
    write_artifacts,
    write_csv,
)

__all__ = ["load_scenario", "read_obstacles_csv", "read_sample_csv",
           "write_artifacts", "write_csv", "save_checkpoint", "load_checkpoint"]
