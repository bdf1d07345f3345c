from ginfinity_tpu_torch.parallel.mesh import make_data_mesh
from ginfinity_tpu_torch.parallel.search import TopKSearcher

__all__ = ["make_data_mesh", "TopKSearcher"]
