from .checkpoint import ArtifactStore, CheckpointManager
from .fault import HeartbeatMonitor, SimulatedFailure, run_with_restarts

__all__ = ["ArtifactStore", "CheckpointManager", "HeartbeatMonitor",
           "SimulatedFailure", "run_with_restarts"]
