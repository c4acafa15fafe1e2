"""The benchmark's arithmetic on fixed inputs: ns/day, the busy union and
the idle share, the idle gaps by host operation, the name groups, the
roofline bound and the counted FLOPs, and the per-layer readers."""

import math

import pytest
import torch

from portbench import md, metrics, trace
from portbench.check import quantile
from portbench.counts import neighbors, work


def test_ns_per_day():
    # 1,000 steps of 0.5 fs in 10 s: 5e-4 ns in 10 s, 4.32 ns a day
    assert md.ns_per_day(1000, 0.5, 10.0) == pytest.approx(4.32)
    assert md.ns_per_day(336, 0.5, 10.138) == pytest.approx(
        336 * 0.5e-6 * 86400 / 10.138)


def _trace():
    device = [("asn_step_fused_kernel<float>", 0.0, 10.0),
              ("sm90_xmma_gemm_f32", 5.0, 20.0),  # overlaps the first
              ("Memcpy DtoH (Device -> Pageable)", 30.0, 35.0),
              ("elementwise_kernel", 50.0, 60.0),
              ("dh_reduce_kernel", 60.0, 62.0)]
    host = [("aten::item", 20.0, 31.0), ("cudaStreamSynchronize", 22.0, 29.0),
            ("aten::mul", 40.0, 45.0), ("run", -5.0, 100.0)]
    return trace.Trace(device=device, host=host, window_us=105.0)


def test_union_busy_idle():
    tr = _trace()
    assert trace.union([(0, 10), (5, 20), (30, 35)]) == [[0, 20], [30, 35]]
    assert trace.busy_us(tr) == pytest.approx(20 + 5 + 12)
    assert tr.span_us == (-5.0, 100.0)
    assert len(tr.kernels()) == 4
    ctx = metrics.Context(trace=tr, steps=2, regrows=3, work={}, cfg={},
                          tables={}, groups=work.groups())
    assert metrics.read("device_idle_pct", ctx) == pytest.approx(
        100 * (1 - 37 / 105))
    assert metrics.read("launches_per_step", ctx) == pytest.approx(2.0)
    assert metrics.read("regrows_in_window", ctx) == 3.0


def test_groups_and_readers():
    tr = _trace()
    by = trace.device_us_by_group(tr, work.groups())
    assert by == {"asn_kernels": 12.0, "mlp": 15.0, "glue": 15.0}
    ctx = metrics.Context(trace=tr, steps=3, regrows=0, work={}, cfg={},
                          tables={}, groups=work.groups())
    assert metrics.read("asn_kernels_ms_per_step", ctx) == pytest.approx(
        12e-3 / 3)
    assert metrics.read("mlp_ms_per_step", ctx) == pytest.approx(15e-3 / 3)
    assert metrics.read("glue_ms_per_step", ctx) == pytest.approx(15e-3 / 3)


def test_idle_gaps_by_host_operation():
    gaps = trace.idle_gaps_us(_trace())
    # gaps: [-5, 0) run; [20, 30) cudaStreamSynchronize (innermost at 25);
    # [35, 50) aten::mul at 42.5; [62, 100) run
    assert gaps == {"run": 5.0 + 38.0, "cudaStreamSynchronize": 10.0,
                    "aten::mul": 15.0}
    top = trace.top(gaps, 2)
    assert [name for name, _ in top] == ["run", "aten::mul"]
    assert [s for _, s in top] == pytest.approx([43e-6, 15e-6])


def _work():
    return {"atom": 1000, "list_pair": 150000.0, "rad": 60000.0,
            "rep": 58000.0, "ang_nbr": 18000.0, "ang_pair": 150000.0,
            "rad_col": 1000 * 32, "ang_col": 1000 * 96, "atom_force": 1000,
            "box": 1, "species_atoms": [667, 0, 0, 333, 0, 0, 0]}


def test_kernel_bound_takes_the_larger_term():
    tables = work.load("ani2x-xtb-1m")
    w = _work()
    pk = tables["peaks"]
    # packed_fwd: 272 fp32 and 21 special functions a slot pair, 4 bytes an
    # angular AEV entry
    t_instr = 272 * w["ang_pair"] / pk["f32_instr"]
    t_sfu = 21 * w["ang_pair"] / pk["sfu"]
    t_bytes = 4 * w["ang_col"] / pk["bytes_per_s"]
    assert work.kernel_bound_s(tables, "packed_fwd", w) == pytest.approx(
        max(t_instr, t_sfu, t_bytes))
    # wing: 3 operations a list pair at the fma rate against 12 bytes a row
    assert work.kernel_bound_s(tables, "wing", w) == pytest.approx(max(
        3 * w["list_pair"] / pk["f32_flops"], 12 * 1000 / pk["bytes_per_s"]))
    # a rebuild's kernel counts once a rebuild, the others once a step
    b = work.asn_bound_s(tables, w, steps=12, rebuilds=1)
    assert b["build_inv"] == pytest.approx(
        work.kernel_bound_s(tables, "build_inv", w))
    assert b["step_fused"] == pytest.approx(
        12 * work.kernel_bound_s(tables, "step_fused", w))


def test_configuration_rows_override():
    base, own = work.load("ani2x-xtb-1m"), work.load("ani1xnr-8m")
    assert base["kernels"]["packed_bwd"]["instr"] == {"ang_pair": [306, 21]}
    assert own["kernels"]["packed_bwd"]["instr"] == {"ang_pair": [266, 5]}
    assert own["kernels"]["packed_bwd"]["bytes"] == {"ang_col": 4}


def test_step_flops_and_mfu():
    cfg = {"hidden": [[256, 192, 160]] + [[1, 1, 1]] * 2 + [[192, 160, 128]]
           + [[1, 1, 1]] * 3, "num_models": 1}
    w = _work()
    tables = work.load("ani2x-xtb-1m")
    n_in = 128
    macs = 667 * (n_in * 256 + 256 * 192 + 192 * 160 + 160) \
        + 333 * (n_in * 192 + 192 * 160 + 160 * 128 + 128)
    assert work.mlp_flops(cfg, w) == pytest.approx(4 * macs)
    instr = sum(
        sum(v[0] * w[u] for u, v in k.get("instr", {}).items())
        + sum(v * w[u] for u, v in k.get("fma", {}).items())
        for k in tables["kernels"].values())
    flops = work.step_flops(cfg, tables, w, steps=1, rebuilds=1)
    assert flops == pytest.approx(instr + 4 * macs)
    tr = trace.Trace(device=[("asn_build_inv_kernel", 0.0, 1.0)],
                     host=[], window_us=1000.0)
    ctx = metrics.Context(trace=tr, steps=1, regrows=0, work=w, cfg=cfg,
                          tables=tables, groups=work.groups())
    assert metrics.read("step_mfu_pct", ctx) == pytest.approx(
        100 * flops / (1e-3 * 67e12))
    roof = metrics.read("asn_kernels_roofline_pct", ctx)
    assert roof == pytest.approx(100 * sum(
        work.asn_bound_s(tables, w, 1, 1).values()) / 1e-6)


def test_readers_find_nothing_in_an_empty_trace():
    tr = trace.Trace(device=[], host=[], window_us=10.0)
    ctx = metrics.Context(trace=tr, steps=0, regrows=0, work=_work(),
                          cfg={}, tables=work.load("ani2x-xtb-1m"),
                          groups=work.groups())
    for name in ("device_idle_pct", "launches_per_step", "glue_ms_per_step",
                 "mlp_ms_per_step", "asn_kernels_ms_per_step",
                 "asn_kernels_roofline_pct", "step_mfu_pct"):
        assert metrics.read(name, ctx) is None, name


def test_neighbor_counts_from_positions():
    # a cubic lattice of spacing 1 in a box of 12: 6 neighbors within 1.1,
    # 18 within 1.5, 26 within 1.8
    g = torch.arange(12, dtype=torch.float64)
    pos = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    c = neighbors.per_atom_counts(pos, torch.full((3,), 12.0),
                                  (1.1, 1.5, 1.8))
    assert c.shape == (1728, 3)
    assert bool((c == torch.tensor([6, 18, 26])).all())
    cfg = {"aev": {"radial_cutoff": 1.5, "angular_cutoff": 1.1,
                   "eta_r": [1.0], "shf_r": [0.0] * 16, "eta_a": [1.0],
                   "zeta": [1.0], "shf_a": [0.0] * 4, "shf_z": [0.0] * 8},
           "repulsion": {"cutoff": 1.5}, "symbols": ["H", "O"]}
    w = neighbors.work(cfg, {"skin": 0.3}, torch.zeros(1728, dtype=torch.long),
                       pos, torch.full((3,), 12.0))
    assert w["ang_nbr"] == 1728 * 6 and w["rad"] == 1728 * 18
    assert w["list_pair"] == 1728 * 26
    assert w["ang_pair"] == 1728 * 15
    assert w["rad_col"] == 1728 * 16 and w["ang_col"] == 1728 * 32
    assert w["species_atoms"] == [1728, 0]


def test_quantile():
    x = torch.arange(101, dtype=torch.float64)
    assert float(quantile(x, 0.9)) == 90.0
    assert math.isclose(float(quantile(x[:1], 0.9)), 0.0)
