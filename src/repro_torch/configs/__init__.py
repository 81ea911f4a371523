from repro_torch.configs.base import (SHAPES, AMCConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      cell_applicable)
from repro_torch.configs.registry import (ARCHS, all_cells,  # noqa: F401
                                          get_arch, get_shape)
