from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    jax_key,
    leaves,
    port_path,
)
