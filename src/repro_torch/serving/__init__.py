"""Serving plane of the port: the engine, and (loaded on first use) the
fault-injection plan, the metrics registry and the frame codec."""
from repro_torch.serving.engine import ServingEngine, greedy_generate

__all__ = ["ServingEngine", "greedy_generate", "FrameCorruption",
           "FaultPlan", "FaultSpec", "InjectedFault", "ReplicaCrash",
           "random_plan", "MetricsRegistry", "Counter", "Gauge",
           "Histogram"]

_MODULES = {"transport": ("FrameCorruption",),
            "faults": ("FaultPlan", "FaultSpec", "InjectedFault",
                       "ReplicaCrash", "random_plan"),
            "metrics": ("MetricsRegistry", "Counter", "Gauge", "Histogram")}


def __getattr__(name):
    import importlib
    for mod, names in _MODULES.items():
        if name in names:
            return getattr(importlib.import_module(
                f"repro_torch.serving.{mod}"), name)
    raise AttributeError(name)
