from repro_torch.optim.sgd import OptState, Optimizer, Schedule, adam, make_schedule, sgd

__all__ = ["Optimizer", "OptState", "Schedule", "adam", "make_schedule", "sgd"]
