from .pipeline import DataPipeline, PipelineState

__all__ = ["DataPipeline", "PipelineState"]
