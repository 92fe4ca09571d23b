from repro_torch.nn.spec import (  # noqa: F401
    ParamShape,
    abstract,
    count_params,
    encdec_shapes,
    flat_params,
    from_jax_params,
    init_params,
    lm_shapes,
    model_shapes,
    padded_vocab,
)
