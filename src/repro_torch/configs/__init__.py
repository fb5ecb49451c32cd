from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      get_config, list_configs, reduced,
                                      register)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "list_configs", "reduced", "register"]
