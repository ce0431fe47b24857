"""Model FLOPs of a training round: 6 x the parameters a token touches x
the tokens, plus the attention products (QK^T and PV, 2 S hd FLOPs each per
query and head forward, three times that with the backward, half of it
under the causal mask).  A MoE layer counts only each token's routed
(``experts_per_token``) and shared experts; recomputation, the optimizer
and the gossip are not counted.  The tied table counts once, as the
unembedding's product."""
from __future__ import annotations

import math

from portbench.spec import head_dim, leaf_list

EXPERT_LEAVES = ("ffn.w_gate", "ffn.w_up", "ffn.w_down")


def active_params(model: dict) -> float:
    """Parameters a token touches: the stacked routed-expert leaves
    [layers, E, ., .] scaled by k / E."""
    total = 0.0
    E, K = model.get("num_experts", 0), model.get("experts_per_token", 0)
    for path, shape, _, _ in leaf_list(model):
        n = math.prod(shape)
        if E and path.endswith(EXPERT_LEAVES) and len(shape) == 4 and shape[1] == E:
            n = n * K / E
        total += n
    return total


def per_token(model: dict, seq: int) -> float:
    # forward 4 S hd per query and head, x3 with the backward, x0.5 causal
    attn = 12.0 * seq * model["num_heads"] * head_dim(model) * model["num_layers"] * 0.5
    return 6.0 * active_params(model) + attn


def per_round(model: dict, wl: dict) -> float:
    tokens = wl["nodes"] * wl["batch_per_node"] * wl["seq"]
    return tokens * per_token(model, wl["seq"])
