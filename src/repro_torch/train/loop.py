"""Generic training loop (the reference's ``train/loop.py``).

Per step: fetch the batch, run ``step_fn``, record the metrics as floats
every ``sync_every`` steps (which waits for the card), call the
``on_step(step, state, batch)`` hook, and every ``log_every`` steps print
the last recorded metrics.  Checkpointing (ROADMAP.md A7) and
the stage-latency telemetry and straggler accounting (A8) are not ported
yet: ``ckpt_dir``, ``stats`` and ``registry`` raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_dir: Optional[str] = None          # checkpointing (A7)
    sync_every: int = 10
    log_every: int = 0                      # 0 = silent
    stats: Optional[Any] = None             # telemetry sink (A8)
    registry: Optional[Any] = None          # metric registry (A8)
    on_step: Optional[Callable[[int, Any, Any], None]] = None


@dataclasses.dataclass
class LoopResult:
    state: Any
    metrics: List[Dict[str, float]]
    steps_run: int


def run_loop(step_fn: Callable[[Any, Any], tuple], init_state: Any,
             batch_iter: Callable[[int], Any],
             cfg: LoopConfig) -> LoopResult:
    """step_fn(state, batch) -> (state, metrics dict of scalars);
    ``batch_iter(step)`` supplies the step's batch."""
    if cfg.ckpt_dir:
        raise NotImplementedError("checkpointing in run_loop is not ported "
                                  "yet: ROADMAP.md item A7")
    if cfg.stats is not None or cfg.registry is not None:
        raise NotImplementedError("loop telemetry (stats / registry) is not "
                                  "ported yet: ROADMAP.md item A8")
    state = init_state
    history: List[Dict[str, float]] = []
    for step in range(cfg.n_steps):
        batch = batch_iter(step)
        state, metrics = step_fn(state, batch)
        if cfg.sync_every and step % cfg.sync_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **metrics})
        if cfg.on_step is not None:
            cfg.on_step(step, state, batch)
        if cfg.log_every and step % cfg.log_every == 0 and history:
            print(f"[loop] step {step}: {history[-1]}")
    return LoopResult(state=state, metrics=history, steps_run=cfg.n_steps)
