from repro_torch.sharding.specs import (batch_specs, opt_state_specs,
                                        param_specs)

__all__ = ["param_specs", "batch_specs", "opt_state_specs"]
