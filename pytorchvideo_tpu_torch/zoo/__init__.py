"""Weight conversion (counterpart of pytorchvideo_tpu/zoo)."""

from pytorchvideo_tpu_torch.zoo.from_jax import (  # noqa: F401
    MLP_INVERSE_RENAME_RULES,
    MVIT_INVERSE_RENAME_RULES,
    X3D_INVERSE_RENAME_RULES,
    jax_ssl_state_to_state_dict,
    jax_variables_to_state_dict,
)
