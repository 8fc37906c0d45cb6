from repro_torch.wireless.channel import (  # noqa: F401
    CellState,
    ChannelParams,
    los_probability,
    make_cell,
    path_loss_db,
)
