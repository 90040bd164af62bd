from . import attention, common, mlp, moe, ssm, transformer
from .transformer import (decode_step, forward, init_cache, init_params,
                          loss_fn, prefill, prefill_step)
