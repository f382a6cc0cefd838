"""testing/ — deterministic fault injection (``faults.py``)."""

from gke_ray_train_tpu_torch.testing.faults import (  # noqa: F401
    FaultInjector, FaultSpec, InjectedKill, parse_fault_spec, reset_fired)
