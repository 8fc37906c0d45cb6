from repro_torch.roofline.analysis import (  # noqa: F401
    COLLECTIVE_OPS,
    F32_FLOPS,
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    TF32_FLOPS,
    TraceCounter,
    InputShape,
    Roofline,
    count_params,
    model_flops,
    roofline_terms,
)
