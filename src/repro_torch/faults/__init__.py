"""Wireless fault injection + server-side defenses for the round loop.

See ``repro_torch.faults.config.FaultConfig`` for the knobs,
``repro_torch.faults.injector.FaultInjector`` for the per-round
realisation, and ``repro_torch.faults.sanitize`` for the delta screening
applied before Eq. 2 aggregation.
"""
from repro_torch.faults.config import CORRUPT_MODES, FaultConfig  # noqa: F401
from repro_torch.faults.injector import (FAILURE_CAUSES,  # noqa: F401
                                         FaultInjector, RoundFaults)
from repro_torch.faults.sanitize import (SanitizeResult,  # noqa: F401
                                         finite_per_device,
                                         sanitize_updates, tree_is_finite)
