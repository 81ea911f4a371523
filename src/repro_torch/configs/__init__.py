from repro_torch.configs.base import AMCConfig, ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: F401
