from repro_torch.optim.adamw import (AdamState, AMCAdamState, adamw_init,
                                     adamw_update, amc_adamw_init,
                                     amc_adamw_update, make_optimizer)
from repro_torch.optim.schedule import SCHEDULES, cosine, wsd

__all__ = ["AdamState", "AMCAdamState", "adamw_init", "adamw_update",
           "amc_adamw_init", "amc_adamw_update", "make_optimizer",
           "SCHEDULES", "cosine", "wsd"]
