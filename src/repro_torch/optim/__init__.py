from .adamw import (OptimizerConfig, adamw_update, global_norm,
                    init_opt_state, lr_at)
