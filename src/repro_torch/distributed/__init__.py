from repro_torch.distributed.api import (MESH_AXES, AxisRules, FlashDecode,
                                         axis_ctx, current_flash_decode,
                                         current_rules, flash_decode_ctx,
                                         init_mesh, logical_axes, serve_rules,
                                         shard_hidden, train_rules)
