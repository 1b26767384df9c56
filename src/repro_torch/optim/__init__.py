from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import constant_lr, cosine_with_warmup
