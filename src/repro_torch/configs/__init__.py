from repro_torch.configs.base import (AMCConfig, ModelConfig,  # noqa: F401
                                      MoEConfig, ShapeConfig)
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: F401
