"""The yardstick: the FLOP and byte counts against hand counts, the plain
reference against ``repro_torch`` over the checked rounds (dense GELU/MQA
and MoE, ``kq4b`` fused and block top-k), and the comparison failing the
control and every fault a training cell can have, with the timed path
broken underneath a whole run."""
import json
import math

import pytest
import torch

from conftest import ROOT, small_model, write_bench
from portbench import data, harness, spec
from portbench.counting import flops, gossip_bytes
from portbench.reference import compare, follow, gossip, seeds

SEED = 2**31 + 17


# ------------------------------------------------------------------ counting
def test_flops_of_a_dense_model_by_hand():
    m = small_model("granite-20b")  # d 64, 4 heads of 16, 1 kv head, d_ff 96, V 128, 2 layers
    d, f, V, L, S = 64, 96, 128, 2, 16
    attn = d * 4 * 16 + 2 * d * 16 + 4 * 16 * d + 4 * 16 + 2 * 16 + d  # wq wk wv wo + biases
    ffn = 2 * d * f + f + d
    norms = 2 * 2 * d
    per_layer = attn + ffn + norms
    params = V * d + L * per_layer + 2 * d
    assert flops.active_params(m) == params
    wl = {"nodes": 4, "batch_per_node": 2, "seq": S}
    want = 4 * 2 * S * (6 * params + 6 * S * 4 * 16 * L)
    assert flops.per_round(m, wl) == want


def test_flops_of_a_moe_model_count_the_routed_experts_only():
    m = small_model("deepseek-moe-16b")  # 8 experts of 32, top-2, 2 shared; 1 dense + 2 MoE
    d, E, K, f = 64, 8, 2, 32
    full = flops.active_params(dict(m, experts_per_token=E))
    assert full == spec.param_total(m)
    assert full - flops.active_params(m) == 2 * 3 * d * f * (E - K)


def test_fused_gossip_bytes_by_hand():
    m = small_model("granite-20b", dtype="float32", vocab_size=4096, d_model=64)
    wl = {"nodes": 4, "compressor": {"spec": "kq4b"}, "fused_gossip": True}
    got = gossip_bytes.plan(m, wl)
    assert got["kernels"] == ("fused_encode_kernel", "fused_mix_kernel")
    unit = 2 * 8 * 128  # 4 bits: 2 levels a byte, 8 sign rows
    total = 0
    for _, shape, _, _ in spec.leaf_list(m):
        grid = 4 * math.ceil(math.prod(shape) / unit) * unit
        payload = grid * 5 / 8
        total += grid * (4 + 4 + 4 + 4) + payload + 4 * 2 * 4  # encode (f32 leaves)
        total += payload + 2 * grid * 4 + 3 * 4 * 4  # mix
    assert got["bytes"] == total


def test_block_topk_bytes_by_hand():
    m = small_model("granite-20b", dtype="float32")
    wl = {"nodes": 4, "compressor": {"kind": "block_topk", "fraction": 0.25, "block": 64}}
    got = gossip_bytes.plan(m, wl)
    want = sum(8 * 4 * math.ceil(math.prod(s) / 64) * 64 for _, s, _, _ in spec.leaf_list(m))
    assert got == {"kernels": ("block_topk_kernel",), "bytes": want}


def test_scan_plan_of_the_real_leaves():
    """The chunking the gossip (and the noise, and the norms) follow."""
    g = spec.load_config("granite-20b")["model"]
    plans = {p: gossip.scan_plan((4,) + s) for p, s, _, _ in spec.leaf_list(g)}
    assert plans["embed.table"] == (2, 24, 256)
    assert plans["blocks.0.ffn.w1"] == (1, 3, 1)
    assert plans["blocks.0.mixer.wk"] is None


def test_bits_count_by_hand():
    """What the reference's encodes hold: every entry's level and sign and
    one norm an encode (a chunk of a large leaf is its own encode) under
    4-bit quantization; a value and a 6-bit index a kept entry under block
    top-k, a block whose largest magnitude more than k entries share kept
    whole; the busiest node's count to 2 neighbours, plus the dual."""
    q = gossip.Quantize(4)
    r = torch.randn(4, 100)
    assert q(r, torch.rand(q.noise_shape(4, 100)))[1].tolist() == [5 * 100 + 32] * 4
    top = gossip.BlockTopK(0.25, 64)
    r = torch.randn(4, 100)  # blocks of 64 and 36 (zero-padded): 16 kept in each
    r[1, :64] = 1.0  # node 1's first block: 64 tied at its largest magnitude
    value, bits = top(r)
    assert bits.tolist() == [32 * 38, (64 + 16) * 38, 32 * 38, 32 * 38]
    assert torch.equal(value[1, :64], r[1, :64])
    assert gossip.round_bits(bits, 4, 2) == (64 + 16) * 38 * 2 + 32 * 4 * 2


def test_chunked_leaf_bills_one_norm_a_chunk():
    """A leaf past the scan size goes as chunks, one norm each: the count
    the meter's one norm a leaf falls short of."""
    shape = (4, 3, 1 << 23)  # 3 stacked layers of 2^23: a chunk a layer
    assert gossip.scan_plan(shape) == (1, 3, 1)
    comp = gossip.Quantize(4)
    theta = [torch.randn(shape) * 0.01]
    hat, s = [torch.zeros(shape)], [torch.zeros(shape)]
    gen = torch.Generator().manual_seed(SEED)
    sent = gossip.choco_round(theta, hat, s, comp, gossip.ring_shifts(4), 0.5, gen)
    assert sent.tolist() == [5 * 3 * (1 << 23) + 3 * 32] * 4


# ----------------------------------------------------- reference vs the port
#: float32 on both sides: the gaps are the arithmetic's order, 1e-7 at most
CASES = {"dense.kq4b": ("granite-20b", "kq4b"), "dense.btopk": ("granite-20b", "btopk"),
         "moe.kq4b": ("deepseek-moe-16b", "kq4b"), "moe.btopk": ("deepseek-moe-16b", "btopk")}


def _program_and_reference(root, cell, seed=SEED, rounds=2):
    wl = dict(spec.load_workload(cell, root), checked_rounds=rounds)
    model = spec.load_config(f"{cell}-config", root)["model"]
    dev = torch.device("cpu")
    checked, _ = data.batches(wl, model["vocab_size"], seeds(seed)["data"])
    trainer, state = harness.build(model, wl, seed, dev)
    state, auxes, grad = harness.checked_rounds(
        trainer, state, [{"tokens": torch.from_numpy(b)} for b in checked])
    prog = harness.readings(model, seed, state, auxes, grad, dev)
    return prog, checked, model, wl


@pytest.fixture(scope="module")
def f32_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("f32")
    cells = {name: (small_model(base, dtype="float32"), comp, 16)
             for name, (base, comp) in CASES.items()}
    return root, write_bench(root, cells)


@pytest.mark.parametrize("cell", list(CASES))
def test_reference_follows_the_port_over_two_rounds(f32_bench, cell):
    root, _ = f32_bench
    prog, checked, model, wl = _program_and_reference(root, cell)
    ref = follow(model, wl, SEED, checked, torch.device("cpu"))
    found = compare.gaps(prog, ref)
    # the meter bills k entries a block and one norm a leaf; the reference
    # counts what it encoded: at these sizes no leaf is chunked, but under
    # block top-k the dense model's key bias (zero, with no gradient) is a
    # block of ties kept whole every round
    if cell == "dense.btopk":
        assert 0.0 < found["bits_gap"] < 0.05
    else:
        assert found["bits_gap"] == 0.0
    assert max(v for k, v in found.items() if k != "bits_gap") <= 1e-5, found


# ---------------------------------------------------------- control, faults
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "delta_gap": 1e-4, "hat_gap": 1e-4,
          "s_gap": 1e-4, "cerr_gap": 1e-4, "lambda_gap": 1e-4, "bits_gap": 0.01}


def test_control_fails_the_comparison(f32_bench):
    """The reference in float8 e4m3 put in the program's place."""
    root, _ = f32_bench
    _, checked, model, wl = _program_and_reference(root, "dense.kq4b", rounds=3)
    ref = follow(model, wl, SEED, checked, torch.device("cpu"))
    control = follow(model, wl, SEED, checked, torch.device("cpu"), precision="fp8")
    ok, checks = compare.verdict(compare.gaps(control, ref), LIMITS)
    assert not ok, checks


def _break(monkeypatch, fault):
    """Plant ``fault`` in the port, underneath the trainer's step."""
    from repro_torch.core import gossip as pg
    from repro_torch.core import trainer as pt
    from repro_torch.kernels import choco_fused

    if fault == "state_unchanged":
        step = pt.DecentralizedTrainer.step

        def same(self, state, batch, **kw):
            import copy

            _, aux = step(self, copy.deepcopy(state), batch, **kw)
            return state, aux

        monkeypatch.setattr(pt.DecentralizedTrainer, "step", same)
    elif fault == "half_batch":
        oracle = pt.LocalUpdate._oracle

        def half(loss_fn, theta, batch):
            return oracle(loss_fn, theta, {k: v[:, : v.shape[1] // 2] for k, v in batch.items()})

        monkeypatch.setattr(pt.LocalUpdate, "_oracle", staticmethod(half))
    elif fault == "none":
        pass
    elif fault == "no_exchange":
        monkeypatch.setattr(choco_fused, "fused_mix_shifted", lambda lvl, sign, s, *a: s)
        monkeypatch.setattr(pg, "_mix_payload", lambda comp, payload, shape, dtype, topo:
                            torch.zeros((payload.shape[0],) + tuple(shape)))
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch", "no_exchange"])
@pytest.mark.parametrize("comp", ["kq4b", "btopk"])
def test_a_run_with_a_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault, comp):
    """The same run, unbroken, is correct under the same limits."""
    model = small_model("granite-20b", dtype="float32")
    bench_path = write_bench(tmp_path, {"c": (model, comp, 16)}, limits=LIMITS)
    _break(monkeypatch, fault)
    rc = harness.main(["--workload", "c", "--seed", str(SEED), "--seconds", "0.1", "--trace",
                       "0"], device="cpu", bench_path=bench_path, data_root=tmp_path)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is (fault == "none"), line["checks"]


def test_real_limits_sit_between_their_readings():
    """Every cell compares each number with a limit above the lower and
    below the upper reading its workload file records (an exact count has
    the limit 0; a number without an upper reading is not compared)."""
    for path in sorted((ROOT / "portbench" / "workloads").glob("*.json")):
        wl = json.loads(path.read_text())
        assert set(compare.CHECKS) <= set(wl["limits"]) <= set(compare.CHECKS + compare.OPTIONAL)
        for name, limit in wl["limits"].items():
            lo, hi = wl["readings"][name]["lower"], wl["readings"][name]["upper"]
            if limit is None:
                assert hi is None, (path.name, name)
            elif limit == 0:
                assert lo == 0, (path.name, name)
            else:
                assert lo < limit < hi, (path.name, name)


def test_an_optional_number_is_compared_where_a_cell_names_it():
    """``delta_median_gap``: the median leaf's change, each leaf by its
    worst node; compared only in a cell whose limits name it."""
    ref = {"loss": [[1.0]], "grad_norm": [[1.0], [1.0], [1.0]], "delta_norm": [[1.0], [2.0], [4.0]],
           "hat_norm": [[1.0]], "s_norm": [[1.0]], "cerr": [1.0], "lam": [[0.5]], "bits": [10.0]}
    prog = dict(ref, delta_norm=[[1.5], [2.2], [4.0]])  # gaps 0.25, 0.1, 0 (over max(r, 2))
    found = compare.gaps(prog, ref)
    assert found["delta_gap"] == pytest.approx(0.25)
    assert found["delta_median_gap"] == pytest.approx(0.1)
    base = {k: 1.0 for k in compare.CHECKS}
    ok, checks = compare.verdict(found, base)
    assert ok and "delta_median_gap" not in checks
    ok, checks = compare.verdict(found, dict(base, delta_median_gap=0.05))
    assert not ok and list(checks)[-1] == "delta_median_gap"
