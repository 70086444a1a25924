"""Serving plane of the port: the engine, and (loaded on first use) the
serving fabrics, the framed transport, the fault-injection plan, the
metrics registry, the admission scheduler and the load generator. The
lazy loads keep the fabrics, which build on ``core.pipeline``, out of
this package's import (``core`` itself serves through the engine)."""
from repro_torch.serving.engine import ServingEngine, greedy_generate

_MODULES = {"fabric": ("ServingFabric", "Ticket", "QueueLatencyAutoscaler"),
            "procfabric": ("ProcessServingFabric", "WorkerDied",
                           "EpochLagDrainPolicy"),
            "transport": ("FramedChannel", "ChannelClosed",
                          "FrameCorruption"),
            "faults": ("FaultPlan", "FaultSpec", "InjectedFault",
                       "ReplicaCrash", "random_plan"),
            "metrics": ("MetricsRegistry", "Counter", "Gauge", "Histogram"),
            "scheduler": ("ContinuousBatcher", "Request", "serve_trace"),
            "loadgen": ("ArrivalEvent", "poisson_trace", "bursty_trace",
                        "trace_replay")}

__all__ = ["ServingEngine", "greedy_generate"] + \
    [n for names in _MODULES.values() for n in names]


def __getattr__(name):
    import importlib
    for mod, names in _MODULES.items():
        if name in names:
            return getattr(importlib.import_module(
                f"repro_torch.serving.{mod}"), name)
    raise AttributeError(name)
