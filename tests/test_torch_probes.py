"""The probe kernels' plain versions (lammps_ani_torch.probes) vs the JAX
package's Pallas probes in examples/benchmark/.

micro_kernel_variants: each of the six bodies, imported from the JAX probe
by path and run through `pl.pallas_call(..., interpret=True)` with its own
block specs at nc 16, cap 4, W 24, against `radial_variant` on the CPU
(its plain version), on the probe's inputs (uniform on [0, 120)) and on a
dense draw (on [0, 10)) whose pairs reach the cutoff, the recurrence and
its overflow. The columns a body writes must agree: the same NaN and inf
entries, the finite ones within 5e-6 + 1e-4 of the entry. The entries are
sums of non-negative terms t b^k; XLA evaluates exp and cos with its own
approximations and may fuse the distance's products, which moves the
exponent -19.7 x^2 (up to about 100 where t is nonzero) by an ulp or
two, about 1e-5 of t, and the recurrence's 15 products add an ulp each:
up to 2.3e-5 relative on this draw (the card's kernel, which rounds as
the plain version does, is held to 1e-5 there).

micro_gather: `chunk_gather` (a plain function of the JAX probe) against
the gather, and each of the five modes against a numpy transcription of
the bodies (micro_gather.py:101-141), exactly.

micro_pieces: the bare radial kernel's call (its plain version here) on
the coarse grid of the water tile equals `radial_aev_roll`'s forward at
the atoms' slots.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_ani_torch.probes import micro_gather as tmg
from lammps_ani_torch.probes import micro_kernel_variants as tmv
from lammps_ani_torch.probes import micro_pieces as tmp

BENCH = Path(__file__).resolve().parents[1] / "examples" / "benchmark"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain path is a chain of tensor operations; with several
    test processes on one machine, each with a thread per core, the
    threads wait on one another at every operation. One thread keeps this
    file's time flat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmv():
    return _load("micro_kernel_variants")


@pytest.fixture(scope="module")
def jmg():
    return _load("micro_gather")


NC, CAP, W, T_ROWS = 16, 4, 24, 8


def _jax_variant(body, n_out, arrs):
    """The JAX probe's pallas_call (run_variant, micro_kernel_variants.py:59)
    in interpret mode."""
    return pl.pallas_call(
        body, grid=(NC // T_ROWS,),
        in_specs=[pl.BlockSpec((T_ROWS, CAP), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)] * 3
        + [pl.BlockSpec((T_ROWS, W), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec((T_ROWS, CAP, n_out), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NC, CAP, n_out), jnp.float32),
        interpret=True)(*arrs)


def _variant_inputs(hi, seed):
    rng = np.random.default_rng(seed)
    f = [rng.uniform(0, hi, shape).astype(np.float32)
         for shape in [(NC, CAP)] * 3 + [(NC, W)] * 3]
    return f + [rng.integers(-1, 4, (NC, W)).astype(np.int32)]


@pytest.mark.parametrize("hi", [120.0, 10.0])
@pytest.mark.parametrize("stage", tmv.STAGES)
def test_radial_variant_matches_jax_body(jmv, stage, hi):
    arrs = _variant_inputs(hi, seed=int(hi))
    ref = np.asarray(_jax_variant(getattr(jmv, f"v_{stage}"),
                                  tmv.NCOL[stage],
                                  [jnp.asarray(a) for a in arrs]))
    before = tmv.PLAIN_CALLS[stage]
    # XLA's CPU backend flushes subnormal floats to zero: the dense draw's
    # t underflows through them into the recurrence, so the plain version
    # runs under the same flush
    flush = torch.set_flush_denormal(True)
    try:
        got = tmv.radial_variant(stage, *[torch.from_numpy(a) for a in arrs])
    finally:
        torch.set_flush_denormal(False)
    assert flush
    assert tmv.PLAIN_CALLS[stage] == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    cols = tmv.WRITTEN[stage]
    got, ref = got.numpy()[..., :cols], ref[..., :cols]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_array_equal(got[~fin & ~np.isnan(ref)],
                                  ref[~fin & ~np.isnan(ref)])
    np.testing.assert_array_less(np.abs(got[fin] - ref[fin]),
                                 5e-6 + 1e-4 * np.abs(ref[fin]))
    if hi == 10.0 and stage != "geom_only":
        # the dense draw reaches the cutoff: nonzero terms are compared
        assert (np.abs(ref[fin]) > 0).any()


def test_variant_counts_match_their_sizes():
    assert tmv.variant_bytes("full32", 2, 3, 5) == 4 * (18 + 40 + 192)
    assert tmv.variant_ops("geom_only", 2, 3, 5) == {"fp32": 10 * 30,
                                                      "sfu": 30}
    # the kernel's form: a masked sum is one fma(t, m, acc)
    assert tmv.variant_ops("full32", 2, 3, 5, n_in=7) == {
        "fp32": 79 * 30 + 4 * 7, "sfu": 3 * 30}
    # the count before the kernel fused them: a product and a sum each
    assert tmv.variant_ops("full32", 2, 3, 5, n_in=7, fused=False) == {
        "fp32": 111 * 30 + 4 * 7, "sfu": 3 * 30}
    # the pairs that evaluate the cosine, against a numpy count
    args = tmv.make_inputs(4, 3, 50, seed=2, hi=10.0)
    p = np.stack([t.numpy() for t in args[:3]], -1)
    c = np.stack([t.numpy() for t in args[3:6]], -1)
    d = np.sqrt(np.maximum(((p[:, :, None] - c[:, None]) ** 2).sum(-1),
                           1e-12))
    n_in = tmv.pairs_within(*args[:6], row_chunk=3)
    assert n_in == int((d <= 5.1).sum()) and 0 < n_in < d.size


GATHER_SHAPES = dict(n_tiles=2, cap=3, w=200, k=10)


@pytest.fixture(scope="module")
def gather_inputs():
    return tmg.make_inputs(**GATHER_SHAPES, seed=5)


def _numpy_bodies(mode, x, idx, widx, g, k):
    """micro_gather.py:101-141 transcribed to numpy over all rows."""
    r = x.shape[0] * x.shape[1]
    w = x.shape[2]
    xv, iv = x.reshape(r, w), idx.reshape(r, 128)
    if mode == "affine":
        return (x * np.float32(2.0) + np.float32(1.0))
    if mode == "gather1":
        return np.take_along_axis(xv, iv[:, :k], 1).reshape(*x.shape[:2], k)
    if mode == "gather3":
        acc = np.zeros((r, k), np.float32)
        for c in range(3):
            acc = acc + np.take_along_axis(xv + np.float32(c), iv[:, :k], 1)
        return acc.reshape(*x.shape[:2], k)
    if mode == "decompact":
        gpad = np.pad(g.reshape(r, k), ((0, 0), (0, 128 - k)))
        wv = widx.reshape(r, w)
        return np.take_along_axis(gpad, np.clip(wv, 0, 127), 1).reshape(
            x.shape)
    lane = np.arange(w)[None, :]
    cols = [np.sum((lane == iv[:, a:a + 1]).astype(np.float32) * xv, -1)
            for a in range(k)]
    return np.stack(cols, -1).reshape(*x.shape[:2], k)


@pytest.mark.parametrize("mode", tmg.MODES)
def test_compact_modes_match_numpy_bodies(gather_inputs, mode):
    inp = gather_inputs
    ref = _numpy_bodies(mode, *(inp[key].numpy() for key in
                                ("x", "idx", "widx", "g")), inp["k"])
    x, idx = tmg._operands(mode, inp)
    before = tmg.PLAIN_CALLS[mode]
    got = tmg.compact(mode, x, idx, inp["k"])
    assert tmg.PLAIN_CALLS[mode] == before + 1
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chunk_gather_matches_gather1(jmg, gather_inputs):
    """The JAX probe's chunk_gather (ceil(W/128) in-vreg gathers) gives
    the port's gather, bit for bit."""
    inp = gather_inputs
    k, w = inp["k"], inp["x"].shape[2]
    xv = inp["x"].numpy().reshape(-1, w)
    iv = inp["idx"].numpy().reshape(-1, 128)
    ref = np.asarray(jmg.chunk_gather(jnp.asarray(xv), jnp.asarray(iv), k,
                                      w))
    got = tmg.compact_plain("gather1", inp["x"], inp["idx"], k)
    np.testing.assert_array_equal(got.numpy().reshape(-1, k), ref)


def test_library_calls_compute_the_same_function(gather_inputs):
    inp = gather_inputs
    for mode in tmg.MODES:
        lib = tmg.library_call(mode, inp)
        if lib is None:
            continue
        x, idx = tmg._operands(mode, inp)
        want = (inp["x"] if mode == "affine"
                else tmg.compact_plain(mode, x, idx, inp["k"]))
        np.testing.assert_array_equal(lib().numpy(), want.numpy())


def test_gather_bytes_count_distinct_elements(gather_inputs):
    inp = gather_inputs
    rows = inp["idx"][..., :inp["k"]].reshape(-1, inp["k"]).numpy()
    distinct = sum(len(set(r)) for r in rows)
    assert tmg.compact_bytes("gather1", inp) == 4 * (2 * rows.size
                                                      + distinct)


def test_bare_kernel_call_gives_radial_aev_roll():
    s = tmp.setup(rep=3, device="cpu")
    assert s["grid"].ncells == (3, 3, 3) and s["pos"].shape[0] == 810
    out = tmp.bare_call(s)()
    ref = tmp.ar.radial_aev_roll(s["spec"], s["grid"], s["bins"], s["pos"],
                                 s["box"], species_counts=s["counts"],
                                 shell=1)
    np.testing.assert_array_equal(out[s["bins"].cell, s["bins"].slot].numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("mode", ["gather1", "gather3", "onehot",
                                  "decompact"])
def test_out_of_range_indices_give_zero(jmg, mode):
    """An index outside [0, W) (outside [0, K) for the decompaction) gives
    0, as the TPU probe's chunk gathers give it."""
    inp = tmg.make_inputs(**GATHER_SHAPES, seed=6)
    w, k = inp["x"].shape[2], inp["k"]
    inp["idx"][..., 0] = w + 3
    inp["idx"][..., 1] = -1
    inp["widx"][..., 0] = k + 1
    ref = _numpy_bodies(mode, *(inp[key].numpy() for key in
                                ("x", "idx", "widx", "g")), k) \
        if mode in ("onehot", "decompact") else None
    x, idx = tmg._operands(mode, inp)
    got = tmg.compact(mode, x, idx, k)
    if mode == "decompact":
        assert float(got[..., 0].abs().max()) == 0.0
    else:
        assert float(got[..., :2].abs().max()) == 0.0
        xv = inp["x"].numpy().reshape(-1, w)
        iv = inp["idx"].numpy().reshape(-1, 128)
        jref = np.asarray(jmg.chunk_gather(jnp.asarray(xv), jnp.asarray(iv),
                                           k, w))
        if mode == "gather1":
            np.testing.assert_array_equal(got.numpy().reshape(-1, k), jref)
    if ref is not None:
        np.testing.assert_array_equal(got.numpy(), ref)
