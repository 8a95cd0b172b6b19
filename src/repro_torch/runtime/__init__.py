"""repro_torch.runtime — fault injection and the failure taxonomy.

Port of the part of ``repro.runtime`` the serving layer needs so far:
``faults`` (FaultPlan, classify_failure, RetryPolicy).  Elastic
re-meshing, stragglers and the train loop come with recovery and the
multi-GPU slices (ROADMAP A5, A6).
"""

_SUBMODULES = ("faults",)

__all__ = list(_SUBMODULES)


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.runtime.{name}")
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
