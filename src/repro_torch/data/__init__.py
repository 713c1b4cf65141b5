from repro_torch.data.pipeline import DataPipeline
