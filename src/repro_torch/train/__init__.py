from repro_torch.train.loop import LoopConfig, LoopResult, run_loop

__all__ = ["LoopConfig", "LoopResult", "run_loop"]
