"""Config registry (copy of ``repro.configs``): import every arch module to
populate the registry.  Framework-free data; the port refuses the families
it cannot run yet in ``models/model_zoo.py``, not here."""
from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b,
                                 gemma3_12b, h2o_danube_3_4b,
                                 llava_next_mistral_7b, mamba2_130m,
                                 qwen2_0_5b, qwen2_1_5b, whisper_tiny,
                                 zamba2_7b)  # noqa: F401
from repro_torch.configs.base import (SHAPES, ArchConfig, RunShape,
                                      cell_is_supported, get_config,
                                      list_archs)

__all__ = ["SHAPES", "ArchConfig", "RunShape", "cell_is_supported",
           "get_config", "list_archs"]
