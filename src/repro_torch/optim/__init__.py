from repro_torch.optim.optimizers import (Optimizer, adagrad, adamw,
                                          clip_by_global_norm,
                                          multi_optimizer)

__all__ = ["Optimizer", "adagrad", "adamw", "clip_by_global_norm",
           "multi_optimizer"]
