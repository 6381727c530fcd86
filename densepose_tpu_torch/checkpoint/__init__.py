from .spec import ParamSpec, Spec  # noqa: F401
from .pkl_loader import load_checkpoint_file, align_state_dicts, convert_c2_names  # noqa: F401
from .transform import (fold_frozen_bn, fold_state, params_from_jax,  # noqa: F401
                        random_torch_state)
