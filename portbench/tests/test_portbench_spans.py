"""The recorded pass's arithmetic (portbench/spans.py) and its six
readers on a synthetic pass: the correlation join of a kernel to its
launch, the launch to the innermost span on its thread, the fallback of
autograd's device thread to the recording thread's span, the layers, the
sync-gap rule, the idle gaps by span with the "(outside the program)"
charge, and None where nothing was recorded."""

import pytest

from lammps_ani_torch.utils.profiling import Span
from portbench import md, metrics, spans, trace
from portbench.counts import work

MAIN = 0x7F00_1234_5000  # threading.get_ident() values
GRAD = 0x7F00_9876_5000
NATIVE = {MAIN: 118, GRAD: 128}  # threading.get_native_id()


def _int32(tid):
    """The thread as a CUDA-only trace's launch record carries it."""
    v = tid & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _span(name, s, e, tid, parent, site=None):
    sp = Span(name, s, tid, parent)
    sp.end_ns = e
    if site:
        sp.notes = {"site": site}
    return sp


SPANS = [_span("chunk", 0, 1000, MAIN, None),               # 0
         _span("rebuild", 10, 100, MAIN, 0),                # 1
         _span("sync", 50, 90, MAIN, 1, "roll_count"),      # 2
         _span("step", 100, 700, MAIN, 0),                  # 3
         _span("skin_check", 100, 150, MAIN, 3),            # 4
         _span("sync", 120, 150, MAIN, 4, "skin_check"),    # 5
         _span("integrate", 150, 200, MAIN, 3),             # 6
         _span("forces", 200, 600, MAIN, 3),                # 7
         _span("aev_forward", 210, 300, MAIN, 7),           # 8
         _span("nn_forward", 300, 400, MAIN, 7),            # 9
         _span("grad", 400, 600, MAIN, 7),                  # 10
         _span("aev_backward", 450, 500, GRAD, 10),         # 11
         _span("integrate", 600, 700, MAIN, 3),             # 12
         _span("thermo", 700, 800, MAIN, 0)]                # 13

# (name, start, end, launch time, launching thread or None: no record)
EVENTS = [("elementwise_kernel", 30, 40, 20, MAIN),
          ("asn_build_inv_kernel", 40, 45, 30, MAIN),
          ("Memcpy DtoH (Device -> Pinned)", 60, 62, 55, MAIN),
          ("reduce_kernel", 112, 118, 110, MAIN),
          ("Memcpy DtoH (Device -> Pinned)", 126, 128, 125, MAIN),
          ("vectorized_elementwise_kernel", 160, 170, 160, MAIN),
          ("asn_step_fused_kernel", 225, 240, 220, MAIN),
          ("index_gather_kernel", 250, 260, 250, MAIN),
          ("sm90_xmma_gemm_f32", 310, 330, 310, MAIN),
          ("celu_kernel", 335, 345, 334, MAIN),
          ("sum_backward_kernel", 410, 415, 410, MAIN),
          ("elu_backward_kernel", 420, 430, 420, GRAD),  # no span on GRAD
          ("constant_pad_kernel", 460, 470, 460, GRAD),
          ("asn_packed_bwd_kernel", 470, 490, 465, GRAD),
          ("strain_kernel", 610, 620, 610, MAIN),
          ("orphan_kernel", 900, 905, None, None),
          ("copy_kernel", 950, 960, 950, MAIN)]
STEPS = 2


def _pass(events=EVENTS, spans_=SPANS, syncs=None, steps=STEPS,
          native=False):
    """The synthetic pass, its launch records' threads as a CUDA-only
    trace carries them (or, `native`, as their native ids)."""
    device, launches = [], {}
    for corr, (name, s, e, t, tid) in enumerate(events, start=1):
        device.append((name, float(s), float(e), corr))
        if t is not None:
            launches[corr] = (float(t), NATIVE.get(tid, tid) if native
                              else _int32(tid))
    return spans.Pass(device=device, launches=launches, spans=spans_,
                      main_tid=MAIN, threads=dict(NATIVE),
                      syncs={"roll_count": 1, "skin_check": 1}
                      if syncs is None else syncs,
                      steps=steps, window_ns=(-50.0, 1100.0))


def _ctx(p):
    ctx = metrics.Context(trace=trace.Trace(device=[], host=[],
                                            window_us=0.0),
                          steps=0, regrows=0, work={}, cfg={}, tables={},
                          groups=work.groups())
    ctx.recorded = p
    return ctx


@pytest.mark.parametrize("native", [False, True], ids=["pthread", "native"])
def test_launches_join_by_correlation_and_thread(native):
    p = _pass(native=native)
    got = [(name, i) for name, _, _, i in spans.attribute(p)]
    names = [None if i is None else SPANS[i].name for _, i in got]
    assert names == ["rebuild", "rebuild", "sync", "skin_check", "sync",
                     "integrate", "aev_forward", "aev_forward", "nn_forward",
                     "nn_forward", "grad",
                     # autograd's thread: no span of its own at 420, so
                     # the recording thread's innermost (grad)
                     "grad", "aev_backward", "aev_backward", "integrate",
                     None, "chunk"]
    # a launch record's thread that matches no span's falls back too
    p2 = _pass(events=[("k", 460, 470, 460, 0x1111_2222)])
    assert [SPANS[i].name for *_, i in spans.attribute(p2)] == ["grad"]


def test_device_time_by_layer_and_group():
    by = spans.device_ns_by_layer(_pass(), work.groups())
    assert dict(by["rebuild"]) == {"glue": 12.0, "asn_kernels": 5.0}
    assert dict(by["integrate"]) == {"glue": 28.0}
    assert dict(by["aev"]) == {"asn_kernels": 35.0, "glue": 20.0}
    assert dict(by["mlp"]) == {"mlp": 20.0, "glue": 25.0}
    assert dict(by[None]) == {"glue": 15.0}


def test_sync_gap_rule():
    p = _pass()
    # the gaps opening at 62 (inside the roll_count read, until 112) and
    # at 128 (inside the skin check's, until 160); those opening at 45
    # and 118, before each read began, are the host's pace
    assert spans.sync_idle_ns(p) == 50.0 + 32.0
    assert spans.gaps(p)[:3] == [(-50.0, 30.0), (45.0, 60.0), (62.0, 112.0)]


def test_idle_gaps_by_span():
    got = spans.idle_gaps_by_span(_pass())
    assert got == {spans.OUTSIDE: 80.0 + 140.0, "sync": 15 + 50 + 8 + 32,
                   "integrate": 55.0, "aev_forward": 60.0,
                   "nn_forward": 70.0, "grad": 155.0, "thermo": 280.0,
                   "chunk": 45.0}
    busy = trace.busy_us(trace.Trace(
        device=[(n, s, e) for n, s, e, _ in _pass().device], host=[],
        window_us=0.0))
    assert sum(got.values()) == pytest.approx(1150.0 - busy)


def test_readers():
    ctx = _ctx(_pass())
    got = {name: metrics.read(name, ctx) for name in (
        "host_syncs_per_step", "sync_idle_ms_per_step",
        "rebuild_ms_per_step", "integrate_ms_per_step",
        "aev_glue_ms_per_step", "mlp_glue_ms_per_step")}
    assert got == pytest.approx({
        "host_syncs_per_step": 2 / STEPS,
        "sync_idle_ms_per_step": 82e-6 / STEPS,
        "rebuild_ms_per_step": 17e-6 / STEPS,
        "integrate_ms_per_step": 28e-6 / STEPS,
        "aev_glue_ms_per_step": 20e-6 / STEPS,
        "mlp_glue_ms_per_step": 25e-6 / STEPS})
    out = spans.split(_pass(), work.groups())
    assert out["glue_by_name_ms_per_step"] == pytest.approx(
        (12 + 28 + 20 + 25 + 15) * 1e-6 / STEPS)
    assert out["events_outside_chunk"] == 1
    assert out["charged_share"] == pytest.approx(155.0 / 160.0)


@pytest.mark.parametrize("p", [None, "no_steps", "no_device"])
def test_readers_find_nothing_where_nothing_was_recorded(p):
    p = {None: None, "no_steps": _pass(steps=0),
         "no_device": _pass(events=[])}[p]
    ctx = _ctx(p)
    for name in ("host_syncs_per_step", "sync_idle_ms_per_step",
                 "rebuild_ms_per_step", "integrate_ms_per_step",
                 "aev_glue_ms_per_step", "mlp_glue_ms_per_step"):
        assert metrics.read(name, ctx) is None, name


def test_the_pass_runs_once_from_the_callers_run(monkeypatch):
    calls = []

    def fake(run_, traffic, recording=True):
        calls.append((run_, traffic))
        return _pass()

    monkeypatch.setattr(spans, "record", fake)
    ctx = _ctx(None)
    del ctx.recorded
    assert metrics.read("host_syncs_per_step", ctx) is None  # no caller
    assert ctx.recorded is None and not calls
    del ctx.recorded

    def per_layer(c, run):
        return [metrics.read(n, ctx) for n in ("host_syncs_per_step",
                                               "rebuild_ms_per_step")]

    run = md.Run(sim=None, state=None, generator=None)
    c = {"traffic": {"trace": {"chunks": 2}}, "workload": {}}
    assert per_layer(c, run) == pytest.approx([1.0, 17e-6 / STEPS])
    assert calls == [(run, c["traffic"])]
