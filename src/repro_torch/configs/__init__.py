"""The ten model configurations and the (arch × shape) registry.
Counterpart of ``repro.configs``: the same numbers, copied."""
from repro_torch.configs.registry import (ARCHS, SHAPES, get_config,
                                          input_specs, list_archs, runnable,
                                          smoke_config)
