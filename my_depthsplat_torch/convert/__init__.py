from .from_jax import (
    encoder_state_dict,
    load_flax_params,
    prompt_dpt_state_dict,
    promptda_state_dict,
    vit_state_dict,
)

__all__ = [
    "encoder_state_dict",
    "load_flax_params",
    "prompt_dpt_state_dict",
    "promptda_state_dict",
    "vit_state_dict",
]
