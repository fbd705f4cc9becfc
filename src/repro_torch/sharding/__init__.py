from repro_torch.sharding.ctx import activation_sharding, constrain
from repro_torch.sharding.specs import (SERVE_RULES, TRAIN_RULES, P,
                                        NamedSharding, param_shardings,
                                        spec_for, tree_param_specs)

__all__ = [
    "activation_sharding", "constrain", "NamedSharding", "P",
    "SERVE_RULES", "TRAIN_RULES",
    "param_shardings", "spec_for", "tree_param_specs",
]
