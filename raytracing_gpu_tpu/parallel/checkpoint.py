"""Checkpoint / resume for inverse-rendering training state.

The reference has nothing long-running and therefore no checkpointing
(SURVEY §5); this framework's training loop does. Orbax handles the
actual serialization (sharded-array aware: vertex/normal params sharded over
the scene axis restore with their shardings when a mesh/abstract target is
supplied).
"""

from __future__ import annotations

import os
from typing import Any

import jax

from raytracing_gpu_tpu.parallel.train import TrainState


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save_train_state(directory: str, state: TrainState) -> str:
    """Write the TrainState under `directory` (one checkpoint per step).

    Idempotent per step: re-saving the same step (e.g. a periodic save at
    the loop tail followed by the final save) overwrites instead of
    raising orbax's destination-exists error.
    """
    step = int(jax.device_get(state.step))
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    _checkpointer().save(path, jax.device_get(state), force=True)
    return path


def latest_checkpoint(directory: str) -> str | None:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory) if d.startswith("step_")
    )
    return os.path.join(directory, steps[-1]) if steps else None


def restore_train_state(path: str, like: TrainState | None = None) -> TrainState:
    """Restore a TrainState. Pass `like` (a state with the target structure,
    e.g. freshly initialized) to restore with matching dtypes/shardings."""
    ckpt = _checkpointer()
    if like is not None:
        restored = ckpt.restore(path, item=jax.device_get(like))
    else:
        restored = ckpt.restore(path)
    if isinstance(restored, TrainState):
        return restored
    # orbax may return the registered-pytree's flattened dict form
    return TrainState(
        params=restored["params"] if isinstance(restored, dict) else restored[0],
        opt_state=restored["opt_state"] if isinstance(restored, dict) else restored[1],
        step=restored["step"] if isinstance(restored, dict) else restored[2],
    )


def resume_or_init(directory: str, init_state: TrainState) -> tuple[TrainState, bool]:
    """(state, resumed): restore the latest checkpoint or use init_state."""
    path = latest_checkpoint(directory)
    if path is None:
        return init_state, False
    return restore_train_state(path, like=init_state), True
