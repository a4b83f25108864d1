"""Synthetic LM data pipeline of the port (port of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, DataPipeline,
                                       PipelineState, global_batch,
                                       shard_batch)

__all__ = ["DataConfig", "DataPipeline", "PipelineState", "global_batch",
           "shard_batch"]
