from . import attention, common, mlp, transformer
from .transformer import (decode_step, forward, init_cache, init_params,
                          prefill, prefill_step)
