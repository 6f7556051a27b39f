"""The DeCafNet grounder, its variants and their parts (port of
decafnet_tpu.models)."""

from .decafnet import (TWO_HEAD_NAMES, DeCafNetEarlyFusion, DeCafNetIterative,
                       DeCafNetLateFusion, check_time_sharding, init_random,
                       make_model, require_two_heads, resolve_compute_dtype)
from .import_torch import (load_params, load_pth, params_from_state_dict,
                           save_pth, state_dict_from_params)
from .points import fpn_lengths, generate_points, select_points


def random_params(cfg, seed):
    """Random weights for ``cfg`` as a flax-layout numpy params tree, drawn
    from a ``torch.Generator`` seeded by ``seed``."""
    return params_from_state_dict(init_random(make_model(cfg), seed).state_dict())
