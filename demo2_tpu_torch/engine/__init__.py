from .eval import MISS_MASKS, eval_step, miss_mask
