"""Architecture configs of the port (the dense subset of ``repro.configs``)."""
from repro_torch.configs import archs as _archs
from repro_torch.configs.base import (ArchConfig, EncoderSpec, MoESpec,
                                      get_config, list_configs, scaled_down)

ALL_ARCHS = _archs.ALL

__all__ = ["ArchConfig", "EncoderSpec", "MoESpec", "get_config",
           "list_configs", "scaled_down", "ALL_ARCHS"]
