from repro_torch.nn.spec import (  # noqa: F401
    ParamShape,
    count_params,
    flat_params,
    from_jax_params,
    init_params,
    lm_shapes,
    padded_vocab,
)
