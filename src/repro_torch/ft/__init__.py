"""Fault tolerance around the train step: port of ``src/repro/ft``."""
from .resilience import (FailurePlan, NodeFailure, StragglerMonitor,
                         TrainDriver)

__all__ = ["FailurePlan", "NodeFailure", "StragglerMonitor", "TrainDriver"]
