"""FedCGD core: the paper's contribution (WEMD, bandwidth-feasible
scheduling) and the Eq. 10-12 estimators."""
from repro_torch.core.scheduling import (  # noqa: F401
    Problem,
    Schedule,
    best_channel,
    best_norm,
    coordinate_descent,
    exhaustive,
    fed_cbs,
    fscd,
    greedy_scheduling,
    power_of_choice,
    random_schedule,
    solve_many,
)
from repro_torch.core.wemd import p1_objective, wemd_of_set  # noqa: F401
from repro_torch.core.bandwidth import (min_bandwidth,  # noqa: F401
                                        uplink_rate)
