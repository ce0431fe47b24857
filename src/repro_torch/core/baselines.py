"""Baselines the paper compares against (Table 1, §5.2), PyTorch port of
``repro.core.baselines``: CHOCO-SGD, AD-GDA with the dual frozen at the
prior (DR-DSGD and DRFA are not yet ported; see ROADMAP.md)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.adgda import ADGDAConfig, LossFn, adgda_trainer
from repro_torch.core.trainer import DecentralizedTrainer

__all__ = ["choco_sgd"]


def choco_sgd(config: ADGDAConfig, loss_fn: LossFn, prior=None, *, mesh=None,
              node_axes="data", device="cuda") -> DecentralizedTrainer:
    """CHOCO-SGD = AD-GDA with the dual frozen at the prior."""
    return adgda_trainer(dataclasses.replace(config, robust=False), loss_fn, prior, mesh=mesh,
                         node_axes=node_axes, device=device)
