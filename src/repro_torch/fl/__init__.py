from repro_torch.fl.rounds import FederatedTrainer, FLConfig  # noqa: F401
from repro_torch.fl.client import (make_local_update,  # noqa: F401
                                   make_round_core, payload_bits)
from repro_torch.fl.server import aggregate  # noqa: F401
from repro_torch.fl.multicell import MultiCellTrainer  # noqa: F401
from repro_torch.faults import FaultConfig, FaultInjector  # noqa: F401
