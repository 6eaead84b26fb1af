from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_step, load_checkpoint,
                                                 save_checkpoint)
from repro_torch.checkpoint.packed import (load_packed_checkpoint,
                                           save_packed_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "AsyncCheckpointer", "save_packed_checkpoint",
           "load_packed_checkpoint"]
