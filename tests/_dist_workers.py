"""Ranks of a gloo process group on the CPU for the port's process-group
tests (tests/test_torch_comm.py, tests/test_torch_domain_dist.py), and
the cases they run. It imports no JAX: each rank is its own interpreter,

    python -m tests._dist_workers CASE PX,PY,PZ RANK WORLD WORKDIR

started by `Ranks`, which gives the group a `FileStore` under WORKDIR,
pins each rank to one thread, kills every rank and fails when one fails
or the group outlives its time limit, and reads back what each rank
saved (`WORKDIR/rank{r}.pt`). The cases take the mesh as an argument:
`Ranks(..., local=True)` runs the same case on `LocalMesh` in one process
(WORLD 0, no group), the reference, beside the group.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# a collective that waits longer than this raises on its rank
PG_TIMEOUT = timedelta(seconds=120)


class Ranks:
    """`world` ranks of CASE on a gloo group, started at once; `join()`
    waits for them (at most `timeout` seconds from the start) and returns
    each rank's saved result. A context manager: leaving it kills any
    rank still running."""

    def __init__(self, case: str, mesh_shape, workdir, timeout=420.0,
                 local=False):
        self.dir = Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.world = 1 if local else int(np.prod(mesh_shape))
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        shape = ",".join(str(int(p)) for p in mesh_shape)
        self.logs = [open(self.dir / f"rank{r}.log", "wb")
                     for r in range(self.world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests._dist_workers", case, shape,
             str(r), "0" if local else str(self.world), str(self.dir)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for log in self.logs:
            log.close()

    def _tail(self, r, n=3000) -> str:
        self.logs[r].flush()
        return (self.dir / f"rank{r}.log").read_bytes()[-n:].decode(
            errors="replace")

    def join(self) -> list:
        while any(p.poll() is None for p in self.procs):
            failed = [r for r, p in enumerate(self.procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > self.deadline:
                self.close()
                r = failed[0] if failed else 0
                why = (f"rank {r} failed" if failed
                       else "the group outlived its time limit")
                raise AssertionError(f"{why}:\n{self._tail(r)}")
            time.sleep(0.05)
        self.close()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{self._tail(r)}")
        return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def main(argv):
    import torch.distributed as dist

    from lammps_ani_torch.parallel.comm import LocalMesh, ProcessGroupMesh

    case, shape, rank, world, workdir = argv
    mesh_shape = tuple(int(p) for p in shape.split(","))
    rank, world, workdir = int(rank), int(world), Path(workdir)
    torch.set_num_threads(1)
    if world == 0:
        result = CASES[case](lambda: LocalMesh(mesh_shape), workdir)
        torch.save(result, workdir / "rank0.pt")
        return
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(workdir / "store"), world),
        rank=rank, world_size=world, timeout=PG_TIMEOUT)
    try:
        result = CASES[case](lambda: ProcessGroupMesh(mesh_shape), workdir)
        torch.save(result, workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh's primitives
# ---------------------------------------------------------------------------

def _blocks(mesh, salt, shape, kind):
    """[n_local, *shape] blocks, each drawn from (salt, its flat shard
    index), so every backend gives a shard the same block."""
    out = []
    for shard in mesh.local_shards:
        rng = np.random.default_rng([salt, shard])
        if kind == "float":
            out.append(rng.standard_normal(shape))
        elif kind == "quarter":  # sums of these are exact in f64
            out.append(rng.integers(-64, 64, shape) / 4.0)
        elif kind == "int":
            out.append(rng.integers(-1000, 1000, shape))
        else:  # "bool": some True; "rare": mostly False on every shard
            out.append(rng.random(shape) < (0.3 if kind == "bool" else 0.05))
    return torch.as_tensor(np.stack(out))


def comm_case(make_mesh, workdir=None) -> dict:
    """Every primitive of the mesh on seeded per-shard blocks."""
    mesh = make_mesh()
    xf = _blocks(mesh, 1, (4, 3), "float")
    xi = _blocks(mesh, 2, (5,), "int")
    xb = _blocks(mesh, 3, (5,), "bool")
    out = {"coords": mesh.coords(), "local": list(mesh.local_shards),
           "rank": mesh.rank,
           "axis_index": torch.stack([mesh.axis_index(a) for a in range(3)],
                                     dim=1)}
    for axis in range(3):
        for d in (1, -1):
            tag = f"{axis}{d:+d}"
            out["shift_float" + tag] = mesh.shift(xf, axis, d)
            out["shift_int" + tag] = mesh.shift(xi, axis, d)
            out["shift_bool" + tag] = mesh.shift(xb, axis, d)
            w = _blocks(mesh, 10 + 2 * axis + (d > 0), (4, 3), "float")
            x = xf.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((mesh.shift(x, axis, d) * w).sum(), x)
            out["grad" + tag] = g
            out["inverse" + tag] = mesh.shift(w, axis, -d)
    xq = _blocks(mesh, 4, (4, 3), "quarter")
    out.update(
        psum_float=mesh.psum(xf), psum_quarter=mesh.psum(xq),
        psum_int=mesh.psum(xi), pmax_float=mesh.pmax(xf),
        pmax_int=mesh.pmax(xi), pmax_bool=mesh.pmax(xb),
        pmax_rare=mesh.pmax(_blocks(mesh, 5, (8,), "rare")),
        gather_float=mesh.all_gather(xf), gather_int=mesh.all_gather(xi),
        gather_bool=mesh.all_gather(xb))
    g = mesh.rank_generator(torch.Generator().manual_seed(7))
    out["draw"] = torch.randn(4, generator=g, dtype=torch.float64)
    return out


# ---------------------------------------------------------------------------
# DomainSimulation
# ---------------------------------------------------------------------------

F64 = torch.float64
# the mesh's system: WATER30 replicated, a brick at least rlist a side
SYSTEM = {(3, 2, 1): (3, 2, 2), (2, 2, 2): (2, 2, 2)}
SKIN = {"xla": 2.0, "pallas_asn": 1.0}
TRANSLATE = 1.5  # A along each axis: atoms cross the brick faces
NH = dict(temp=300.0, tdamp=50.0)
NPT = dict(temp=300.0, tdamp=50.0, press=1.0, pdamp=500.0)


def water(rep):
    from lammps_ani_torch.io.lammps_data import LammpsData, replicate

    from .fixtures import MASSES, WATER30_POS, WATER30_SPECIES

    d = LammpsData(species=WATER30_SPECIES.astype(np.int64),
                   positions=WATER30_POS, masses_by_type=MASSES,
                   box_bounds=np.array([[-4.0, 4.0]] * 3), tilt=np.zeros(3))
    return replicate(d, *rep)


def box_of(data):
    from lammps_ani_torch.ops.neighbors import Box

    return Box(h=torch.tensor(data.box_h),
               origin=torch.tensor(data.box_origin))


def engine(mesh, engine_name="xla", integrator=None, dspec=None, skin=None,
           dt=0.2, rebuild_every=2):
    """(DomainSimulation on `mesh`, its system)."""
    from lammps_ani_torch.models import zoo
    from lammps_ani_torch.parallel.domain import auto_domain_spec
    from lammps_ani_torch.parallel.sim import DomainSimulation

    data = water(SYSTEM[mesh.mesh_shape])
    skin = SKIN[engine_name] if skin is None else skin
    pot = zoo.ani2x(num_models=1, dtype=F64, device="cpu")
    if dspec is None:
        dspec = auto_domain_spec(data.n_atoms, data.box_h, mesh.mesh_shape,
                                 max(5.1, pot.spec.cutoff) + skin, k_max=160)
    dsim = DomainSimulation(pot, dspec, cutoff=5.1, skin=skin, dt=dt,
                            rebuild_every=rebuild_every,
                            integrator=integrator, dtype=F64, device="cpu",
                            engine=engine_name, mesh=mesh)
    return dsim, data


def start(dsim, data, vel=None, temp=None, seed=1, by=0.0):
    st = dsim.init_state(data.species, data.masses_by_type[data.species],
                         data.positions, box_of(data),
                         vel=(np.zeros_like(data.positions)
                              if vel is None and temp is None else vel),
                         temp=temp, seed=seed)
    return st.replace(pos=st.pos + by) if by else st


def layout(dsim, state):
    """[n_shards, n_cap] gid of every slot (the mesh's layout)."""
    return dsim.mesh.all_gather(state.gid.reshape(dsim.mesh.n_local, -1))


def digest(pot) -> str:
    """The potential's weights and spec, hashed."""
    h = hashlib.sha256(repr(pot.spec).encode())
    for name, b in sorted(pot.named_buffers()):
        h.update(name.encode() + b.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _fields(dsim, state, *names):
    return {k: dsim.gather(state, k) for k in names}


def _eval(mesh, name):
    dsim, data = engine(mesh, name)
    st = dsim.evaluate(start(dsim, data, by=TRANSLATE))
    sizing = dsim.sizing()
    mesh_of = (sizing.pop("backend"), sizing.pop("n_local"))
    return {"engine": dsim.engine, "pe": st.pe, "virial": st.virial,
            "mesh": mesh_of,
            "layout": layout(dsim, st), "sizing": sizing,
            "params": digest(dsim.potential),
            **_fields(dsim, st, "force", "pos")}


def _nve(mesh, steps=3):
    dsim, data = engine(mesh)
    st = start(dsim, data, by=TRANSLATE)
    before = layout(dsim, st)
    st, _ = dsim.run(st, steps)
    return {"layout_before": before, "layout": layout(dsim, st),
            "pe": st.pe, "virial": st.virial,
            **_fields(dsim, st, "pos", "vel", "force")}


def _restart_nh(mesh, workdir, steps=2):
    """NoseHoover from the test process's `LocalMesh` restart, saved again
    after `steps` steps (rank 0 writes)."""
    from lammps_ani_torch.md import integrate

    dsim, _ = engine(mesh, integrator=integrate.NoseHoover(**NH))
    st = dsim.load_restart(workdir.parent / "local.npz")
    loaded = _fields(dsim, st, "pos", "vel")
    st, rows = dsim.run(st, steps, thermo_every=1)
    dsim.save_restart(workdir / "restart.npz", st)
    return {"loaded": loaded, "rows": rows, "step": st.step,
            "eta": st.thermostat.eta, "eta_dot": st.thermostat.eta_dot,
            **_fields(dsim, st, "pos", "vel")}


def _npt(mesh, steps=2):
    from lammps_ani_torch.md import integrate

    dsim, data = engine(mesh, integrator=integrate.NoseHooverNPT(**NPT))
    st, rows = dsim.run(start(dsim, data, temp=300.0), steps, thermo_every=1)
    return {"h": st.box.h, "h_bytes": st.box.h.numpy().tobytes(),
            "omega": st.barostat.omega, "rows": rows,
            **_fields(dsim, st, "pos", "vel")}


def _regrow(mesh):
    """Halo capacities at a sixth of `auto_domain_spec`'s, below what the
    system sends: `evaluate` grows them on every rank alike."""
    dsim, data = engine(mesh)
    dsim.dspec = dataclasses.replace(dsim.dspec, halo_cap=tuple(
        c // 6 for c in dsim.dspec.halo_cap))
    st = dsim.evaluate(start(dsim, data))
    return {"kinds": dict(dsim.regrow_kinds), "dspec": dsim.dspec,
            "pe": st.pe, **_fields(dsim, st, "force")}


def _langevin(mesh, steps=4):
    from lammps_ani_torch.md import integrate

    lang = integrate.Langevin(temp=300.0, damp=50.0,
                              generator=torch.Generator().manual_seed(3))
    dsim, data = engine(mesh, integrator=lang)
    st = start(dsim, data, temp=300.0, by=TRANSLATE)
    st, rows = dsim.run(st, steps, thermo_every=1)
    return {"rows": rows, "layout": layout(dsim, st),
            **_fields(dsim, st, "pos")}


def _skin(mesh, steps=4):
    """rebuild_every far too long for skin 0.35 A from a hot start: chunks
    stop early and `run` still makes every step."""
    dsim, data = engine(mesh, skin=0.35, dt=0.4, rebuild_every=steps)
    vel = 0.05 * np.random.default_rng(5).standard_normal(
        (data.n_atoms, 3))
    st = start(dsim, data, vel=vel)
    chunk, stops = dsim._chunk, []

    def counted(state, take):
        out = chunk(state, take)
        stops.append(out[4] < take)
        return out

    dsim._chunk = counted
    st, _ = dsim.run(st, steps)
    return {"stops": stops, "step": st.step, **_fields(dsim, st, "pos")}


def domain_case(make_mesh, workdir) -> dict:
    """Every scenario of the mesh's system (tests/test_torch_domain_dist.py
    says which)."""
    mesh = make_mesh()
    out = {"eval_xla": _eval(mesh, "xla"),
           "eval_pallas_asn": _eval(mesh, "pallas_asn")}
    if mesh.mesh_shape == (3, 2, 1):
        out.update(nve=_nve(mesh), restart_nh=_restart_nh(mesh, workdir),
                   npt=_npt(mesh), regrow=_regrow(mesh))
    else:
        out.update(langevin=_langevin(mesh), skin=_skin(mesh))
    out["calls"] = dict(getattr(mesh, "calls", {}))
    return out


CASES = {"comm": comm_case, "domain": domain_case}

if __name__ == "__main__":
    main(sys.argv[1:])
