from repro_torch.data.pipeline import (BigramTask, DataConfig, PrefetchIterator,
                                       make_batch, to_device)

__all__ = ["BigramTask", "DataConfig", "PrefetchIterator", "make_batch",
           "to_device"]
