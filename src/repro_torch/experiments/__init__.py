from repro_torch.experiments.setup import TrainedSystem, build_system
from repro_torch.experiments.stages import (StageResult, run_baselines,
                                            run_rar_experiment)

__all__ = ["TrainedSystem", "build_system", "StageResult",
           "run_rar_experiment", "run_baselines"]
