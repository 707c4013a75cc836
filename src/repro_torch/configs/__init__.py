"""Architecture registry.  Importing this package registers the GNN
training configs (``--arch graphsage-products`` and friends) and the LMs
served by ``launch/serve.py``: the dense ``qwen3-4b``, ``llama3.2-3b``,
``glm4-9b`` and ``minitron-8b``, the MoE ``qwen2-moe-a2.7b`` and
``kimi-k2-1t-a32b``, the SSM ``mamba2-1.3b``, the hybrid ``zamba2-7b``,
the encoder-decoder ``whisper-medium`` and the VLM ``qwen2-vl-2b``."""
from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME,  # noqa: F401
                                      ModelConfig, ShapeConfig,
                                      applicable_shapes, get_config,
                                      list_archs, register)

# arch modules register themselves on import
from repro_torch.configs import (gnn, glm4_9b, kimi_k2_1t_a32b,  # noqa: F401
                                 llama3_2_3b, mamba2_1_3b, minitron_8b,
                                 qwen2_moe_a2_7b, qwen2_vl_2b, qwen3_4b,
                                 whisper_medium, zamba2_7b)
