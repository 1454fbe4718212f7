from repro_torch.checkpoint.store import (
    latest_step, list_steps, save_checkpoint, step_dir,
)

__all__ = ["save_checkpoint", "latest_step", "step_dir", "list_steps"]
