"""repro_torch.runtime — fault injection, the failure taxonomy, elastic
re-partitioning.

Port of the one-device part of ``repro.runtime``: ``faults`` (FaultPlan,
classify_failure, RetryPolicy; the recovering executor and the sinks
check its sites) and ``elastic`` (replan_pcc, host_shard_plan).  The
mesh side of ``elastic`` comes with the multi-GPU slice (ROADMAP A6);
stragglers and the train loop with the LM side.
"""

_SUBMODULES = ("faults", "elastic")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.runtime.{name}")
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
