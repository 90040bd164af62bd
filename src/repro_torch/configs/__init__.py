from .base import (EncoderConfig, MLAConfig, ModelConfig, MoEConfig, SHAPES,
                   SSMConfig, ShapeConfig, VisionConfig, cell_applicable)
from .registry import ARCHS, dryrun_cells, get_config, smoke_config
