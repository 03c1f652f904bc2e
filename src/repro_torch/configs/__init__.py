from repro_torch.configs.base import (ARCH_IDS, ModelConfig, get_config,
                                      get_smoke_config)

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_smoke_config"]
