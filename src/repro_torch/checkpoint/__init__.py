from repro_torch.checkpoint.store import (
    AsyncCheckpointer, latest_step, list_steps, restore_checkpoint,
    save_checkpoint, step_dir,
)

__all__ = ["AsyncCheckpointer", "latest_step", "list_steps",
           "restore_checkpoint", "save_checkpoint", "step_dir"]
