from ginfinity_tpu_torch.parallel.search import TopKSearcher

__all__ = ["TopKSearcher"]
