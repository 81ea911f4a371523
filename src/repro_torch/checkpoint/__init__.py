from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, all_steps,
                                         latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "all_steps", "latest_step", "restore", "save"]
