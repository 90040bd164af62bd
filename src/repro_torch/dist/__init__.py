"""The sharding layer (``repro.dist`` on DTensor)."""
from . import sharding
from .sharding import (Mesh, PSpec, batch_axes, current_mesh, hint,
                       param_pspecs, set_attn_fallback, use_mesh)
