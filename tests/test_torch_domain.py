"""The port's domain decomposition (lammps_ani_torch/parallel/domain.py,
the in-process mesh of parallel/comm.py, the ext paths of ops/nbr_grad.py
and models/potential.py) against the JAX package's functions run under
`shard_map` on the 8 virtual CPU devices of tests/conftest.py.

WATER30 replicated 4x4x4 (1,920 atoms, a 32 A cube), f64, rlist 6.1, on
meshes (1,1,1), (2,1,1) and (2,2,2); both sides get the same sharded
layout. Integer and bool outputs must be equal; `halo_positions` within
1e-12 A; `atomic_energies_ext` and its gradients within 1e-12 relative.
The JAX references are built once per mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_tpu.ops import nbr_grad as jnbr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_tpu.parallel import domain as jdom
from lammps_ani_tpu.parallel import sim as jsim
from lammps_ani_torch.models import potential as tpotmod
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import nbr_grad as tnbr
from lammps_ani_torch.ops.neighbors import Box
from lammps_ani_torch.parallel import domain as tdom
from lammps_ani_torch.parallel.comm import LocalMesh

from .fixtures import MASSES, WATER30_POS, WATER30_SPECIES

MESHES = [(1, 1, 1), (2, 1, 1), (2, 2, 2)]
RLIST = 6.1
K = 128
CELL_CAP = 32
BIN_CAP = 32
CAPS = (24, 0, 0, 16, 0, 0, 0)
AX = jdom.AXIS_NAMES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def system():
    """(wrapped positions, species, masses, box h, origin) of WATER30 x 4^3."""
    rep = 4
    shifts = np.array([(i, j, k) for i in range(rep) for j in range(rep)
                       for k in range(rep)], np.float64) * 8.0
    pos = (WATER30_POS[None] + shifts[:, None]).reshape(-1, 3)
    origin = np.full(3, -4.0)
    h = np.eye(3) * 8.0 * rep
    frac = (pos - origin) / np.diag(h)
    pos = origin + (frac - np.floor(frac)) * np.diag(h)
    species = np.tile(WATER30_SPECIES, rep ** 3).astype(np.int64)
    return pos, species, MASSES[species], h, origin


@functools.lru_cache(maxsize=None)
def layout(mesh_shape, halo_cap=None):
    """(DomainSpec, pos [S*cap, 3], species, valid, gid): each atom in
    the brick of its fractional position, in input order."""
    pos, species, _, h, origin = system()
    dspec = tdom.auto_domain_spec(len(species), h, mesh_shape, RLIST, k_max=K)
    if halo_cap is not None:
        dspec = tdom.DomainSpec(mesh_shape, dspec.n_cap, halo_cap,
                                dspec.mig_cap, K)
    shape = np.asarray(mesh_shape)
    frac = np.clip((pos - origin) / np.diag(h), 0.0, np.nextafter(1.0, 0.0))
    sc = np.minimum((frac * shape).astype(np.int64), shape - 1)
    shard = (sc[:, 0] * shape[1] + sc[:, 1]) * shape[2] + sc[:, 2]
    ns, cap = int(shape.prod()), dspec.n_cap
    gpos = np.tile(origin + 0.5 * np.diag(h), (ns * cap, 1))
    gspecies = np.full(ns * cap, -1, np.int64)
    gid = np.full(ns * cap, -1, np.int64)
    fill = np.zeros(ns, np.int64)
    for i in range(len(species)):
        r = shard[i] * cap + fill[shard[i]]
        gpos[r], gspecies[r], gid[r] = pos[i], species[i], i
        fill[shard[i]] += 1
    return dspec, gpos, gspecies, gspecies >= 0, gid


def jmesh(mesh_shape):
    n = int(np.prod(mesh_shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(mesh_shape), AX)


def shard_call(mesh_shape, fn, sharded, replicated):
    """fn(*sharded_per_shard, *replicated) under shard_map; every output
    leaf is per shard, concatenated along dim 0."""
    f = jsim._shard_map(
        fn, mesh=jmesh(mesh_shape),
        in_specs=tuple([P(AX)] * len(sharded) + [P()] * len(replicated)),
        out_specs=P(AX))
    return jax.tree.map(np.asarray, jax.jit(f)(*sharded, *replicated))


def jbox():
    _, _, _, h, origin = system()
    return jnp.asarray(h), jnp.asarray(origin)


def tbox():
    _, _, _, h, origin = system()
    return Box(h=torch.tensor(h), origin=torch.tensor(origin))


def per_shard(x, ns):
    return x.reshape((ns, -1) + x.shape[1:])


def grids(mesh_shape):
    _, _, _, h, _ = system()
    return (tdom.BrickGrid.for_box(h, mesh_shape, RLIST, CELL_CAP),
            tdom.BrickRollGrid.for_box(h, mesh_shape, RLIST, RLIST, BIN_CAP))


@functools.lru_cache(maxsize=None)
def jax_rebuild(mesh_shape, halo_cap=None):
    """The JAX package's halo plan, extended arrays, neighbor builds, brick
    bins and ext rows of every shard."""
    dspec, pos, species, valid, _ = layout(mesh_shape, halo_cap)
    jspec = jdom.DomainSpec(dspec.mesh_shape, dspec.n_cap, dspec.halo_cap,
                            dspec.mig_cap, dspec.k_max)
    _, _, _, h, _ = system()
    bgrid = jdom.BrickGrid.for_box(h, mesh_shape, RLIST, CELL_CAP)
    rgrid = jdom.BrickRollGrid.for_box(h, mesh_shape, RLIST, RLIST, BIN_CAP)

    def fn(pos, species, valid, bh, bo):
        box = jnb.Box(h=bh, origin=bo)
        plan = jdom.build_halo_plan(jspec, pos, species, valid, box, RLIST)
        pos_ext = jdom.halo_positions(jspec, pos, box, plan)
        v_ext, sp_ext = plan.ext_valid(valid), plan.ext_species(species)
        out = {"overflow": plan.overflow[None], "pos_ext": pos_ext,
               "sp_ext": sp_ext, "v_ext": v_ext}
        for i, st in enumerate(plan.stages):
            out.update({f"{k}{i}": getattr(st, k) for k in (
                "send_idx", "send_valid", "recv_valid", "recv_species")})
            out[f"send_shift{i}"] = st.send_shift[None]
        if halo_cap is not None:
            return out
        out["nb"] = jdom.build_neighbor_matrix_ext(pos, valid, pos_ext,
                                                   v_ext, RLIST, K)
        out["nbb"] = jdom.build_neighbor_matrix_brick(
            jspec, bgrid, pos, valid, pos_ext, v_ext, box, RLIST, K)
        out["er"] = jdom.build_ext_rows(pos, valid, pos_ext, v_ext, RLIST, K)
        out["erb"] = jdom.build_ext_rows_brick(
            jspec, bgrid, pos, valid, pos_ext, v_ext, box, RLIST, K)
        out["nb"] = out["nb"][:2] + (out["nb"][2][None],)
        for key in ("nbb", "er", "erb"):
            out[key] = out[key][:2] + (out[key][2][None],)
        bins = jdom.build_bins_brick(rgrid, jspec.mesh_shape, pos_ext, sp_ext,
                                     v_ext, box)
        out["bins"] = (bins.cell, bins.slot, bins.species_grid, bins.inv,
                       bins.count_max[None])
        return out

    return shard_call(mesh_shape, fn, (jnp.asarray(pos), jnp.asarray(
        species, jnp.int32), jnp.asarray(valid)), jbox())


@functools.lru_cache(maxsize=None)
def torch_rebuild(mesh_shape, halo_cap=None):
    dspec, pos, species, valid, _ = layout(mesh_shape, halo_cap)
    ns = dspec.n_shards
    mesh = LocalMesh(mesh_shape)
    box = tbox()
    pos_t = torch.tensor(pos).reshape(ns, -1, 3)
    sp_t = torch.tensor(species).reshape(ns, -1)
    v_t = torch.tensor(valid).reshape(ns, -1)
    plan = tdom.build_halo_plan(mesh, dspec, pos_t, sp_t, v_t, box, RLIST)
    pos_ext = tdom.halo_positions(mesh, dspec, pos_t, box, plan)
    return mesh, dspec, pos_t, sp_t, v_t, plan, pos_ext


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("halo_cap", [None, (64, 96, 128)])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_halo_plan_matches_jax(mesh_shape, halo_cap):
    ref = jax_rebuild(mesh_shape, halo_cap)
    _, dspec, _, sp_t, v_t, plan, pos_ext = torch_rebuild(mesh_shape,
                                                          halo_cap)
    ns = dspec.n_shards
    for i, st in enumerate(plan.stages):
        same(st.send_idx.reshape(-1), ref[f"send_idx{i}"])
        same(st.send_valid.reshape(-1), ref[f"send_valid{i}"])
        same(st.send_shift, ref[f"send_shift{i}"])
        same(st.recv_valid.reshape(-1), ref[f"recv_valid{i}"])
        same(st.recv_species.reshape(-1), ref[f"recv_species{i}"])
    same(plan.overflow, ref["overflow"])
    assert bool(plan.overflow.any()) == (halo_cap is not None)
    same(plan.ext_species(sp_t), per_shard(ref["sp_ext"], ns))
    same(plan.ext_valid(v_t), per_shard(ref["v_ext"], ns))
    np.testing.assert_allclose(pos_ext.numpy(), per_shard(ref["pos_ext"], ns),
                               rtol=0, atol=1e-12)


def test_halo_backward_is_the_owners_sum():
    """The halo's backward: every ghost's cotangent lands on its owner (an
    atom's gradient is the sum over its copies), on (2,2,2) where copies
    cross shards and wrap the box."""
    mesh, dspec, pos_t, _, v_t, plan, _ = torch_rebuild((2, 2, 2))
    box = tbox()
    p = pos_t.clone().requires_grad_(True)
    ext = tdom.halo_positions(mesh, dspec, p, box, plan)
    w = torch.randn(ext.shape, generator=torch.Generator().manual_seed(3),
                    dtype=ext.dtype)
    v_ext = plan.ext_valid(v_t)
    (g,) = torch.autograd.grad((torch.where(v_ext[..., None], ext, 0.0)
                                * w).sum(), p)
    _, _, _, _, gid = layout((2, 2, 2))
    # the copies of each atom: its owned slot and every ghost of it (a plan
    # over the gids as "species" carries them along)
    gid_t = torch.tensor(gid).reshape(dspec.n_shards, -1)
    gid_ext = tdom.build_halo_plan(mesh, dspec, pos_t, gid_t, v_t, box,
                                   RLIST).ext_species(gid_t)
    want = np.zeros((len(system()[1]), 3))
    np.add.at(want, gid_ext[v_ext].numpy(), w[v_ext].numpy())
    got = g.reshape(-1, 3).numpy()[gid >= 0]
    np.testing.assert_allclose(got, want[gid[gid >= 0]], rtol=0, atol=1e-12)


def displaced(mesh_shape, seed=1, scale=0.8):
    """The layout's payload with every atom moved by a seeded displacement
    (re-wrapped), so atoms cross brick faces."""
    dspec, pos, species, valid, gid = layout(mesh_shape)
    _, _, masses, h, origin = system()
    rng = np.random.default_rng(seed)
    moved = pos + scale * rng.standard_normal(pos.shape) * valid[:, None]
    frac = (moved - origin) / np.diag(h)
    moved = np.where(valid[:, None],
                     origin + (frac - np.floor(frac)) * np.diag(h), pos)
    mass = np.where(valid, MASSES[np.maximum(species, 0)], 1.0)
    vel = rng.standard_normal(pos.shape) * valid[:, None]
    return dspec, {"pos": moved, "vel": vel, "species": species,
                   "mass": mass, "gid": gid}, valid


@pytest.mark.parametrize("mig_cap", [None, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_migrate_matches_jax(mesh_shape, mig_cap):
    dspec, payload, valid = displaced(mesh_shape)
    if mig_cap is not None:
        dspec = tdom.DomainSpec(dspec.mesh_shape, dspec.n_cap,
                                dspec.halo_cap, mig_cap, dspec.k_max)
    jspec = jdom.DomainSpec(dspec.mesh_shape, dspec.n_cap, dspec.halo_cap,
                            dspec.mig_cap, dspec.k_max)
    keys = ("pos", "vel", "species", "mass", "gid")

    def fn(pos, vel, species, mass, gid, valid, bh, bo):
        pl, v, ovf = jdom.migrate(
            jspec, dict(pos=pos, vel=vel, species=species, mass=mass,
                        gid=gid), valid, jnb.Box(h=bh, origin=bo))
        return pl, v, ovf[None]

    jargs = [jnp.asarray(payload[k], jnp.int32 if k in ("species", "gid")
                         else jnp.float64) for k in keys]
    jpl, jv, jovf = shard_call(mesh_shape, fn, (*jargs, jnp.asarray(valid)),
                               jbox())
    ns = dspec.n_shards
    tpl = {k: torch.tensor(payload[k]).reshape((ns, dspec.n_cap)
                                                + payload[k].shape[1:])
           for k in keys}
    pl, v, ovf = tdom.migrate(LocalMesh(mesh_shape), dspec, tpl,
                              torch.tensor(valid).reshape(ns, -1), tbox())
    for k in keys:
        same(pl[k].reshape((-1,) + pl[k].shape[2:]), jpl[k])
    same(v.reshape(-1), jv)
    same(ovf, jovf)
    moved = mesh_shape != (1, 1, 1)
    assert bool(ovf.any()) == (moved and mig_cap is not None)
    if moved and mig_cap is None:
        # atoms changed shards and none was lost or doubled
        gid = pl["gid"].reshape(-1).numpy()
        assert not np.array_equal(gid, payload["gid"])
        assert np.array_equal(np.sort(gid[gid >= 0]),
                              np.arange(len(system()[1])))


def row_sets(idx, mask):
    return np.sort(np.where(np.asarray(mask), np.asarray(idx), -1), axis=-1)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_neighbor_builds_match_jax(mesh_shape):
    ref = jax_rebuild(mesh_shape)
    mesh, dspec, pos_t, _, v_t, plan, pos_ext = torch_rebuild(mesh_shape)
    ns, box = dspec.n_shards, tbox()
    v_ext = plan.ext_valid(v_t)
    bgrid, _ = grids(mesh_shape)
    built = {
        "nb": tdom.build_neighbor_matrix_ext(pos_t, v_t, pos_ext, v_ext,
                                             RLIST, K),
        "nbb": tdom.build_neighbor_matrix_brick(
            mesh, dspec, bgrid, pos_t, v_t, pos_ext, v_ext, box, RLIST, K),
        "er": tdom.build_ext_rows(pos_t, v_t, pos_ext, v_ext, RLIST, K),
        "erb": tdom.build_ext_rows_brick(mesh, dspec, bgrid, pos_t, v_t,
                                         pos_ext, v_ext, box, RLIST, K)}
    for key, (idx, mask, deg) in built.items():
        jidx, jmask, jdeg = ref[key]
        same(mask.sum(-1).reshape(-1), jmask.sum(-1))
        same(row_sets(idx, mask).reshape(-1, K), row_sets(jidx, jmask))
        same(deg, jdeg)
    # the brute and brick builds agree with each other, too
    same(row_sets(*built["nb"][:2]), row_sets(*built["nbb"][:2]))
    same(row_sets(*built["er"][:2]), row_sets(*built["erb"][:2]))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_brick_grids_and_bins_match_jax(mesh_shape):
    _, _, _, h, _ = system()
    bgrid, rgrid = grids(mesh_shape)
    jb = jdom.BrickGrid.for_box(h, mesh_shape, RLIST, CELL_CAP)
    jr = jdom.BrickRollGrid.for_box(h, mesh_shape, RLIST, RLIST, BIN_CAP)
    assert dataclasses_equal(bgrid, jb) and dataclasses_equal(rgrid, jr)
    assert rgrid.roll.ncells == jr.roll.ncells and rgrid.roll.cap == jr.cap
    ref = jax_rebuild(mesh_shape)
    mesh, dspec, _, sp_t, v_t, plan, pos_ext = torch_rebuild(mesh_shape)
    bins = tdom.build_bins_brick(mesh, rgrid, pos_ext, plan.ext_species(sp_t),
                                 plan.ext_valid(v_t), tbox())
    ns = dspec.n_shards
    cell, slot, sgrid, inv, cmax = (per_shard(x, ns) for x in ref["bins"])
    for s, b in enumerate(bins):
        same(b.cell, cell[s])
        same(b.slot, slot[s])
        same(b.species_grid, sgrid[s])
        same(b.inv, inv[s])
        same(b.count_max, cmax[s][0])
        same(b.mask_grid, sgrid[s] >= 0)
    # every occupied bin is interior: the pad layers stay empty
    nx, ny, nz = rgrid.ncells
    for b in bins:
        occ = (b.species_grid >= 0).any(1).reshape(nx, ny, nz)
        assert not (occ[0].any() or occ[-1].any() or occ[:, 0].any()
                    or occ[:, -1].any() or occ[:, :, 0].any()
                    or occ[:, :, -1].any())


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("mesh_shape", MESHES + [(4, 2, 2)])
def test_grid_factories_match_jax(mesh_shape):
    pos, species, _, h, _ = system()
    for rl in (RLIST, 7.1):
        assert dataclasses_equal(
            tdom.auto_domain_spec(len(species), h, mesh_shape, rl, k_max=112),
            jdom.auto_domain_spec(len(species), h, mesh_shape, rl,
                                  k_max=112))
        for t, j in ((tdom.BrickGrid.for_box(h, mesh_shape, rl, 40),
                      jdom.BrickGrid.for_box(h, mesh_shape, rl, 40)),
                     (tdom.BrickRollGrid.for_box(h, mesh_shape, rl, rl, 12),
                      jdom.BrickRollGrid.for_box(h, mesh_shape, rl, rl, 12))):
            assert (t is None and j is None) or dataclasses_equal(t, j)
    # the early-earth config's geometry (49,000 atoms, an 80.17 A cube)
    h50 = np.eye(3) * 80.17028
    assert dataclasses_equal(
        tdom.auto_domain_spec(49000, h50, (2, 2, 2), 6.2, k_max=112),
        jdom.auto_domain_spec(49000, h50, (2, 2, 2), 6.2, k_max=112))


@functools.lru_cache(maxsize=None)
def pots():
    jpot = jzoo.ani2x(num_models=1, dtype=jnp.float64)
    tpot = tzoo.ani2x(num_models=1, dtype=torch.float64, device="cpu",
                      params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    import dataclasses
    jpot = jpotmod.ANIPotential(
        spec=dataclasses.replace(jpot.spec, angular_caps=CAPS),
        params=jpot.params)
    return jpot, tpot.with_spec(dataclasses.replace(tpot.spec,
                                                    angular_caps=CAPS))


@pytest.mark.parametrize("shard", [0, 7])
def test_mirror_ext_and_energies_match_jax(shard):
    """build_mirror_ext on JAX's own rows exactly; atomic_energies_ext and
    its gradients with respect to pos and pos_ext, with and without the
    mirror tables, on one shard of (2,2,2)."""
    ref = jax_rebuild((2, 2, 2))
    dspec, pos, species, valid, _ = layout((2, 2, 2))
    ns = dspec.n_shards
    take = lambda x: np.asarray(per_shard(x, ns)[shard])  # noqa: E731
    idx, mask = take(ref["nb"][0]), take(ref["nb"][1])
    eidx, emask = take(ref["er"][0]), take(ref["er"][1])
    jm, jmv, jok = jnbr.build_mirror_ext(jnp.asarray(idx), jnp.asarray(mask),
                                         jnp.asarray(eidx),
                                         jnp.asarray(emask))
    tm, tmv, tok = tnbr.build_mirror_ext(*(torch.tensor(x) for x in (
        idx, mask, eidx, emask)))
    same(tm, jm)
    same(tmv, jmv)
    assert bool(tok) and bool(jok)

    p, sp, v = take(pos), take(species), take(valid)
    p_ext, sp_ext = take(ref["pos_ext"]), take(ref["sp_ext"])
    jpot, tpot = pots()
    present = (0, 3)
    for mirror in (False, True):
        def jfn(pl, pe):
            return jpotmod.atomic_energies_ext(
                jpot, jnp.asarray(sp, jnp.int32), pl, pe,
                jnp.asarray(sp_ext, jnp.int32), jnp.asarray(idx),
                jnp.asarray(mask), local_mask=jnp.asarray(v),
                present_species=present,
                mirror_ext=(jm, jmv) if mirror else None)

        je, jg = jax.jit(lambda a, b: (jfn(a, b), jax.grad(
            lambda x, y: jnp.sum(jfn(x, y)), argnums=(0, 1))(a, b)))(
            jnp.asarray(p), jnp.asarray(p_ext))
        je = np.asarray(je)
        pt = torch.tensor(p, requires_grad=True)
        pet = torch.tensor(p_ext, requires_grad=True)
        te = tpotmod.atomic_energies_ext(
            tpot, torch.tensor(sp), pt, pet, torch.tensor(sp_ext),
            torch.tensor(idx), torch.tensor(mask),
            local_mask=torch.tensor(v), present_species=present,
            mirror_ext=(tm, tmv) if mirror else None)
        tg = torch.autograd.grad(te.sum(), (pt, pet))
        scale = np.abs(je).max()
        assert np.abs(te.detach().numpy() - je).max() <= 1e-12 * scale
        for got, want in zip(tg, jg):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= (
                1e-12 * np.abs(want).max())
        assert np.abs(je[~v]).max() == 0.0
