from .optimizer import (AdamWConfig, AdamWState, adamw_update, init_adamw,
                        clip_by_global_norm, global_norm, schedule)
from .delegated import (GradChannelCombiner, combine_op_spec,
                        int8_quantize, int8_dequantize)
