"""``repro_torch.data`` — the synthetic token pipeline and its MapReduce
twin (port of ``src/repro/data``)."""
from .pipeline import TokenPipeline, pipeline_jobs

__all__ = ["TokenPipeline", "pipeline_jobs"]
