"""The wing as the card computes it: an in-order scatter of the lane
cotangents gt over the idx table (lammps_ani_torch/csrc/aev_asn.cu,
`asn_wing_kernel`), held against the gather through inv that the plain
version (`aev_asn.wing_plain`) and the JAX kernel (`_wing_kernel` of
lammps_ani_tpu/ops/aev_asn.py, in interpret mode) compute.

System: WATER30 x 3^3 (810 atoms, 24 A box), jittered by a seeded normal
(0.05 A), sorted by species, one coarse roll grid of bin side >= 7.1 A at
cap 40, sections with the JAX engine's margins (as
tests/test_torch_asn_build.py sizes them), f64; the rebuild's tables from
the port's plain build.

The scatter adds, slot after slot in ascending order, gt[slot, c, k] into
window lane idx[slot, k] for the live compact lanes k. Where build_inv
reported no overflow, idx is the exact inverse of inv, so the scatter adds
the gather's addends in the gather's order less its exact zeros, and the
two agree bit for bit. gt is 0 on the dead compact lanes, as chain_sum
leaves it (tests/test_torch_asn_backward.py holds that).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_torch.ops import aev_asn as tasn

from .test_torch_asn_build import asn_system, grids, sizing

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def tables():
    """The rebuild's (idx, inv) at the sized system, and its shapes."""
    species, pos, h, origin = asn_system()
    sections, kpad, _, _ = sizing(species, pos, h)
    _, t = grids(species, pos, h, origin, torch.float64)
    a = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                              sections, kpad, 7.1)
    assert float(a.ovf) <= 0
    cap = t["grid"].cap
    return dict(idx=a.idx, inv=a.inv, cap=cap, kpad=kpad,
                wpad=a.inv.shape[-1], W=27 * cap, t=t, sections=sections,
                species=species, pos=pos, h=h, origin=origin)


def wing_scatter(gt, idx):
    """The kernel's algorithm: wing [NC, 27 cap, 3] = -(for slot in
    ascending order: acc[idx[slot, k]] += gt[slot, :, k] over the live
    lanes k). Within one slot idx names each window lane at most once, so
    every live window lane takes exactly one add per slot (dead lanes go
    to a sink lane W that is dropped)."""
    nc, cap, _, kpad = gt.shape
    w_all = 27 * cap
    acc = torch.zeros((nc, w_all + 1, 3), dtype=gt.dtype)
    for slot in range(cap):
        w = idx[:, slot].to(torch.int64)
        w = torch.where((w >= 0) & (w < w_all), w, w_all)
        live = w < w_all
        # no window lane twice in one slot
        hits = torch.zeros((nc, w_all + 1), dtype=torch.int64)
        hits.scatter_add_(1, w, live.to(torch.int64))
        assert int(hits[:, :w_all].max()) <= 1
        acc.scatter_add_(1, w[..., None].expand(-1, -1, 3),
                         gt[:, slot].transpose(1, 2))
    return -acc[:, :w_all]


def jax_wing(gt, inv, cap, kpad, wpad):
    """The JAX `_wing_kernel` (interpret mode) on gt [NC, cap, 3, kpad] and
    inv [NC, cap, wpad]: wing [NC, 27 cap, 3] in the port's layout."""
    gt, inv = np.asarray(gt), np.asarray(inv)
    nc = gt.shape[0]
    nc_pad = -(-nc // jasn._T_ROWS) * jasn._T_ROWS

    def pad(a, fill):
        return np.concatenate(
            [a, np.full((nc_pad - nc,) + a.shape[1:], fill, a.dtype)])

    planes = [jnp.asarray(pad(gt[:, :, c], 0.0)) for c in range(3)]
    ainv = jnp.asarray(pad(inv, kpad - 1))
    t_w = jasn._t_wing(cap, kpad, wpad, nc_pad)
    kern = functools.partial(jasn._wing_kernel, cap=cap, kpad=kpad,
                             wpad=wpad, dtype=jnp.float64)
    wing = pl.pallas_call(
        kern, grid=(nc_pad // t_w,),
        in_specs=[jasn._k3_spec(cap, kpad, t_w)] * 3
        + [jasn._k3_spec(cap, wpad, t_w)],
        out_specs=pl.BlockSpec((1, t_w, 3, wpad), lambda i: (0, i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, nc_pad, 3, wpad), jnp.float64),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
        interpret=True,
    )(*planes, ainv)
    return np.asarray(wing)[0, :nc, :, :27 * cap].transpose(0, 2, 1)


def live_gt(tables, kind, seed=11):
    """gt [NC, cap, 3, kpad] in f64: integers in [-64, 64] or a normal
    draw on the live compact lanes, 0 on the dead ones."""
    idx = tables["idx"]
    rng = np.random.default_rng(seed)
    shape = idx.shape[:2] + (3,) + idx.shape[2:]
    vals = (rng.integers(-64, 65, shape).astype(np.float64)
            if kind == "integer" else rng.standard_normal(shape))
    live = (idx.numpy() < tables["W"])[:, :, None, :]
    return torch.tensor(np.where(live, vals, 0.0))


@pytest.fixture(scope="module")
def wings(tables):
    """{kind: (scatter, plain, jax)} for integer and normal gt."""
    out = {}
    for kind in ("integer", "normal"):
        gt = live_gt(tables, kind)
        out[kind] = (wing_scatter(gt, tables["idx"]).numpy(),
                     tasn.wing_plain(gt, tables["inv"]).numpy(),
                     jax_wing(gt.numpy(), tables["inv"].numpy(),
                              tables["cap"], tables["kpad"],
                              tables["wpad"]))
    return out


def test_idx_is_the_exact_inverse_of_inv(tables):
    """On [0, kpad - 2] idx and inv are inverses: every window lane w that
    inv sends to a live compact lane k is idx[k], every live k is named by
    exactly one window lane, and the dead lanes keep the dead markers (idx
    wpad, inv kpad - 1)."""
    idx = tables["idx"].numpy().astype(np.int64)
    inv = tables["inv"].numpy().astype(np.int64)
    kpad, wpad, w_all = tables["kpad"], tables["wpad"], tables["W"]
    nc, cap, _ = idx.shape
    b, a, w = np.nonzero(inv[:, :, :w_all] < kpad - 1)
    k = inv[b, a, w]
    assert len(k) > 0
    np.testing.assert_array_equal(idx[b, a, k], w)
    named = np.zeros((nc, cap, kpad), np.int64)
    np.add.at(named, (b, a, k), 1)
    live = idx < w_all
    assert live.any() and not live.all()
    np.testing.assert_array_equal(named[live], 1)
    np.testing.assert_array_equal(named[~live], 0)
    np.testing.assert_array_equal(idx[~live], wpad)
    bl, al, kl = np.nonzero(live)
    np.testing.assert_array_equal(inv[bl, al, idx[bl, al, kl]], kl)
    assert not live[:, :, kpad - 1].any()
    assert (inv[:, :, w_all:] == kpad - 1).all()


@pytest.mark.parametrize("ref", ["plain", "jax"])
def test_scatter_equals_the_gather_on_integer_gt(wings, ref):
    """Integer-valued gt: the sums are exact in any order, so the scatter
    over idx, the plain gather through inv and the JAX kernel agree
    exactly; any difference would be a mapping error."""
    got, plain, jx = wings["integer"]
    want = plain if ref == "plain" else jx
    assert np.abs(want).max() > 64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ref", ["plain", "jax"])
def test_scatter_matches_the_gather_on_random_gt(wings, ref):
    """A normal draw on the live lanes (f64): 1e-15 of each entry's
    magnitude plus 1e-15 of the largest (the sums run in another order in
    the JAX kernel and in torch's gather-sum)."""
    got, plain, jx = wings["normal"]
    want = plain if ref == "plain" else jx
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15 * scale)


def test_scatter_is_the_gather_of_ordered_slots_bit_for_bit(tables, wings):
    """The gather in the kernel's own order (ascending slots, one add per
    slot, the zeros of dead lanes included) gives the scatter's bits: what
    the card's kernel is held to against the one it replaced."""
    gt = live_gt(tables, "normal")
    inv = tables["inv"].to(torch.int64)
    nc, cap, _, kpad = gt.shape
    w_all = tables["W"]
    iv = torch.where(inv[:, :, :w_all] < kpad, inv[:, :, :w_all], kpad - 1)
    acc = torch.zeros((nc, 3, w_all), dtype=gt.dtype)
    for slot in range(cap):
        acc = acc + torch.gather(gt[:, slot], 2,
                                 iv[:, slot, None, :].expand(-1, 3, -1))
    ordered = (-acc).transpose(1, 2).numpy()
    got = wings["normal"][0]
    assert np.array_equal(got.view(np.int64), ordered.view(np.int64))


def test_an_overflowing_rebuild_is_where_the_two_forms_differ(tables):
    """Sections cut below the real counts: build_inv ranks lanes past a
    section's k_s, inv names a compact lane from two window lanes and the
    gather counts its gt twice where the scatter counts it once. The MD
    engine takes no step at such a rebuild; the test shows why it must
    not."""
    t, sections = tables["t"], tables["sections"]
    cut = tuple((s, k // 2) for s, k in sections)
    a = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                              cut, tables["kpad"], 7.1)
    assert float(a.ovf) > 0
    inv = a.inv.numpy().astype(np.int64)[:, :, :tables["W"]]
    live = inv < tables["kpad"] - 1
    b, s, w = np.nonzero(live)
    keys = (b * inv.shape[1] + s) * tables["kpad"] + inv[b, s, w]
    assert len(np.unique(keys)) < len(keys)  # inv is not injective
    gt = torch.ones(a.idx.shape[:2] + (3,) + a.idx.shape[2:],
                    dtype=torch.float64)
    gt[..., -1] = 0.0
    assert not np.array_equal(wing_scatter(gt, a.idx).numpy(),
                              tasn.wing_plain(gt, a.inv).numpy())


def test_the_wrapper_runs_the_plain_gather_on_the_cpu(tables):
    """`wing(gt, inv, idx)` on CPU tensors is `wing_plain(gt, inv)`, and
    counts one plain call and no launch."""
    gt = live_gt(tables, "normal", seed=12)
    tasn.reset_counts()
    got = tasn.wing(gt, tables["inv"], tables["idx"])
    assert tasn.PLAIN_CALLS["wing"] == 1 and tasn.LAUNCHES["wing"] == 0
    assert torch.equal(got, tasn.wing_plain(gt, tables["inv"]))
    with pytest.raises(ValueError):
        tasn.wing(gt, tables["inv"].to("meta"), tables["idx"])
