from repro_torch.checkpoint.npz import (
    all_steps,
    latest_step,
    load_flat,
    restore,
    restore_jax_params,
    restore_latest,
    save,
    step_path,
    unflatten,
)

__all__ = [
    "all_steps",
    "latest_step",
    "load_flat",
    "restore",
    "restore_jax_params",
    "restore_latest",
    "save",
    "step_path",
    "unflatten",
]
