"""repro_torch.runtime — fault injection, the failure taxonomy, elastic
re-partitioning.

Port of the all-pairs part of ``repro.runtime``: ``faults`` (FaultPlan,
classify_failure, RetryPolicy; the recovering executor and the sinks
check its sites) and ``elastic`` (ElasticPlan, shrink_data_axis,
build_mesh, shrink_mesh, replan_execution, elastic_pcc_plan, replan_pcc,
host_shard_plan).  Stragglers and the train loop come with the LM side
(ROADMAP slice 12b).
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
