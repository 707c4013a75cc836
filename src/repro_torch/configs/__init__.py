"""Architecture registry.  Importing this package registers the GNN
training configs (``--arch graphsage-products`` and friends) and the dense
LMs served by ``launch/serve.py`` (``--arch qwen3-4b``, ``llama3.2-3b``)."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, get_config,
                                      list_archs, register)

# arch modules register themselves on import
from repro_torch.configs import gnn, llama3_2_3b, qwen3_4b  # noqa: F401
