"""repro_torch.runtime — fault injection, the failure taxonomy, elastic
re-partitioning, stragglers and the fault-tolerant train loop.

Port of ``repro.runtime``: ``faults`` (FaultPlan, classify_failure,
RetryPolicy; the recovering executor and the sinks check its sites),
``elastic`` (ElasticPlan, shrink_data_axis, build_mesh, shrink_mesh,
replan_execution, elastic_pcc_plan, replan_pcc, host_shard_plan),
``straggler``, ``train_loop`` (TrainLoop, LoopConfig, FailureInjected)
and ``hlo`` (the collectives' accounting of the dry run).  Submodules
and the train-loop names resolve lazily: the engine's hot paths import
``faults`` without the train loop's stack.
"""

_SUBMODULES = ("faults", "elastic", "straggler", "train_loop", "hlo")
_TRAIN_LOOP_NAMES = ("TrainLoop", "LoopConfig", "FailureInjected")

__all__ = [*_SUBMODULES, *_TRAIN_LOOP_NAMES]


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.runtime.{name}")
    if name in _TRAIN_LOOP_NAMES:
        mod = importlib.import_module("repro_torch.runtime.train_loop")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
