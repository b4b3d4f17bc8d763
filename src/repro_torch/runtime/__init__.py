"""Fault-tolerant training runtime."""

from repro_torch.runtime.loop import TrainLoop, TrainLoopCfg

__all__ = ["TrainLoop", "TrainLoopCfg"]
