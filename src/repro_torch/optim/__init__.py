from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     clip_scale, global_norm)
from repro_torch.optim.schedules import constant_lr, cosine_with_warmup
