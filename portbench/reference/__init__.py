"""The plain reference that decides ``correct``: it follows the program's
first rounds from the same seed, weights and batches, and gives the same
readings (:data:`READINGS`).  It imports nothing of the port.

:func:`follow` runs ``rounds`` AD-GDA rounds (paper Algorithm 1): every
node's loss and float32 gradient at its parameters (node after node, so one
node's float32 copy and gradient are held at a time), the SGD step weighted
by lambda_i[i] / pi_i, the dual's projected ascent and gossip, one CHOCO
round, and the consensus error.  The state is stored in the configuration's
type, as the program stores it; every operation on it is float32.
"""
from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import gossip as G
from portbench.reference.model import Matmul, loss
from portbench.spec import leaf_list, nest

#: what both sides read after the checked rounds
READINGS = ("loss", "grad_norm", "delta_norm", "hat_norm", "s_norm", "cerr", "lam", "bits")


def seeds(seed: int) -> dict:
    """The sub-seeds of a run: weights, token stream, the gossip's noise."""
    return {"weights": seed, "data": seed, "gossip": seed + 1}


def _f32(x):
    return float(x)


@torch.no_grad()
def start_norms(model: dict, seed: int, theta, device) -> list[list[float]]:
    """||theta_i - theta_0|| of every leaf and node, the start weights made
    again leaf by leaf from the seed."""
    out = []
    for i, ((_, shape, init, dt), th) in enumerate(zip(leaf_list(model), theta)):
        t0 = weights.make_leaf(seeds(seed)["weights"], i, shape, init, dt, device).float()
        out.append([_f32(torch.linalg.vector_norm(th[j].float() - t0))
                    for j in range(th.shape[0])])
        del t0
    return out


@torch.no_grad()
def leaf_norms(tree) -> list[list[float]]:
    return [[_f32(torch.linalg.vector_norm(x[j], dtype=torch.float32))
             for j in range(x.shape[0])] for x in tree]


def follow(model: dict, wl: dict, seed: int, batches, device, *, precision: str = "f32",
           fault: str | None = None) -> dict:
    """The readings of ``len(batches)`` rounds from ``seed``.

    ``fault`` plants one of the faults the comparison must catch, in the
    reference put in the program's place: ``"half_batch"`` (the loss and
    gradient over the first half of each node's rows), ``"no_mix"`` (the
    neighbours' messages left out of s)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = wl["nodes"]
    leaves = leaf_list(model)
    comp = G.make_compressor(wl["compressor"])
    shifts = G.ring_shifts(m)
    degree = 2 if m >= 3 else m - 1
    shapes = [(m,) + tuple(s) for _, s, _, _ in leaves]
    gam = G.gamma(comp, shapes)
    mm = Matmul(precision)
    wseed = seeds(seed)["weights"]
    theta = []
    for i, (_, shape, init, dt) in enumerate(leaves):
        leaf = weights.make_leaf(wseed, i, shape, init, dt, device)
        theta.append(leaf[None].expand((m,) + tuple(shape)).clone())
        del leaf
    hat = [torch.zeros_like(x) for x in theta]
    s = [torch.zeros_like(x) for x in theta]
    prior = torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
    lam = prior[None].expand(m, m).clone()
    gen = torch.Generator(device=device).manual_seed(seeds(seed)["gossip"])
    paths = [p for p, _, _, _ in leaves]
    out = {"loss": [], "cerr": [], "bits": []}
    for t, tokens in enumerate(batches):
        tokens = torch.as_tensor(tokens, device=device)
        w = torch.diagonal(lam) / prior
        losses = []
        for i in range(m):
            p32 = [x[i].float().requires_grad_(True) for x in theta]
            rows = tokens[i]
            if fault == "half_batch":
                rows = rows[: rows.shape[0] // 2]
            value = loss(nest(dict(zip(paths, p32))), rows, model, mm)
            grads = torch.autograd.grad(value, p32)
            del p32
            with torch.no_grad():
                if t == 0:
                    out.setdefault("grad_norm", [[0.0] * m for _ in theta])
                    for j, g in enumerate(grads):
                        out["grad_norm"][j][i] = _f32(torch.linalg.vector_norm(g))
                scale = w[i]
                for x, g in zip(theta, grads):
                    x[i].copy_((x[i].float() + (g * scale) * (-wl["eta_theta"])).to(x.dtype))
            del grads
            losses.append(value.detach().float())
        losses = torch.stack(losses)
        lam = G.dual_step(lam, losses, prior, wl["alpha"], wl["eta_lambda"], shifts)
        sent = G.choco_round(theta, hat, s, comp, shifts, gam, gen, skip_mix=fault == "no_mix")
        out["loss"].append([_f32(v) for v in losses])
        out["cerr"].append(G.consensus_error(theta))
        out["bits"].append(G.round_bits(sent, m, degree))
    out["delta_norm"] = start_norms(model, seed, theta, device)
    out["hat_norm"] = leaf_norms(hat)
    out["s_norm"] = leaf_norms(s)
    out["lam"] = lam.tolist()
    return out
