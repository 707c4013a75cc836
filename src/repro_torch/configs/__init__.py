"""Architecture registry.  Importing this package registers the GNN
training configs (``--arch graphsage-products`` and friends)."""
from repro_torch.configs.base import get_config, list_archs, register

# arch modules register themselves on import
from repro_torch.configs import gnn  # noqa: F401
