"""The domain-decomposed MD driver over a (px, py, pz) mesh of shards.

Port of lammps_ani_tpu/parallel/sim.py. One chunk = migrate, halo plan,
the rebuild of each shard's structure, then up to `rebuild_every`
velocity-Verlet steps; the halo exchange runs inside every force
evaluation, so the ghosts' forces reach their owners through autograd.
The mesh (`comm.py`) is `LocalMesh`, every shard in one process on one
device (the default), or `ProcessGroupMesh`, one shard a rank of a
`torch.distributed` process group (`mesh=`). The state holds the
process's shards, [n_local * n_cap, ...] per atom in flat shard order;
`gather`, the restarts and the sizing measures see the whole system
through the mesh's all-gather.

Engines (`engine=`, the counterpart of the JAX package's LAT_ROLL_IMPL;
None resolves as the JAX package does: `pallas_asn` in f32 on the card,
else `xla`):

  * `xla`, the mirror-ext engine (plain PyTorch, as the JAX one is plain
    XLA): each shard's neighbor matrix over its locals and ghosts (brute,
    or per-brick cells from n_cap >= 2048 unless `use_brick_cells` says
    otherwise), with `nbr_grad.build_mirror_ext`'s tables so the force
    backward gathers (`mirror_force=False`: plain autograd); the AEV of
    `potential.atomic_energies_ext`.
  * `pallas_asn`: the eight asn kernels (ops/aev_asn.py) once per shard
    per step, over each brick's padded grid (`domain.BrickRollGrid`: one
    empty pad layer a side, so the kernels run unchanged and their wrap
    shifts contract zero); bins and assignment at each rebuild. The
    sections, angular caps and two occupancy tiers come from one degree
    measure over the whole system (`_derive_tiers_sharded`, the sharded
    engine's own model, not the single-device ladder); the bin cap from
    one probe of every brick. Where a brick holds no bin of side rlist,
    or there are no angular caps, the xla engine runs and a RuntimeWarning
    says so (`dsim.engine` names what ran).

The neighbor radius is rlist = max(cutoff, Rcr) + skin: it is the halo
margin, the neighbor matrix's radius, the brick bin side and the asn keep
radius. The JAX engine takes cutoff + skin, which for ANI-1xnr (Rcr 5.2)
under the usual cutoff 5.1 leaves out a pair that comes within Rcr before
either atom has moved skin/2.

Integrators: None (NVE), `Langevin`, `NoseHoover` and `NoseHooverNPT`, in
the JAX engine's step order, with global sums over the shards (the chains
and the piston see the whole system). Under NoseHooverNPT the brick grids
carry 6% slack; `run` re-derives them when the box leaves it and raises
when a brick gets thinner than rlist. Langevin draws its noise from
`mesh.rank_generator` of the integrator's generator: on `LocalMesh` that
generator over every shard's slots, under the process group one stream a
rank (the JAX engine folds its key per shard: the streams differ).

Neighbor contract as the single-device engine's: a chunk stops before the
step at which an atom has moved more than skin/2 since the rebuild, and
`run` resumes from a fresh rebuild. Each capacity overflow (migration,
halo, k_max and the brick cells, a bin's cap, a compact section, an
angular cap, the last tier's rows) is reported per chunk; `run` grows
exactly that capacity and runs the chunk again from its input state.

The JAX package's environment overrides and what takes their place:

  LAT_ROLL_IMPL         `engine=` (ENGINES).
  LAT_ANG_PACKED,       `pair_stage=` ("packed", the default; "blocks";
  LAT_ANG_TRI           "blocks_full"), as on `md.simulation.Simulation`.
  LAT_SEC_MARGIN        SEC_MARGIN.
  LAT_ANG_CAP_MARGIN    ANG_CAP_MARGIN.
  LAT_ROLL_CAP_MARGIN   ROLL_CAP_MARGIN.
  LAT_ANG_TIERS         ANG_TIERS.
  LAT_ANG_TIER_MIN_N    ANG_TIER_MIN_N (the shard's n_cap).
  LAT_TIER0_MARGIN      TIER0_MARGIN.
  LAT_TIER_ROWS_MARGIN  TIER_ROWS_MARGIN.
  LAT_VERBOSE           nothing: `engine`, `sizing()` and `regrow_kinds`.

Every host decision comes from a value reduced over the mesh, so every
rank of a process group takes the same branch (one that did not would
hang the group at its next exchange):

  * the half-skin displacement that stops a chunk (`pmax`);
  * the kinetic energy and the kinetic tensor of the thermostat, the
    piston and the thermo row, and the mass of the density (`psum`);
  * pe and the strain gradient of the virial: each process differentiates
    its own shards' summed energy (only the halo's shifts carry autograd
    across ranks; an all-reduce inside the graph would scale the gradient
    by the rank count), then `psum`s both;
  * the overflow codes and the force evaluation's deficits (`pmax`);
  * the NPT brick check, on the box, which every rank updates from the
    same reduced values to the same bits;
  * the sizing measures at init_state and at each regrow or re-derive,
    over the whole system: `init_state` takes the global arrays on every
    rank, the regrows `all_gather` them.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .. import units
from .._device import resolve_device
from ..md import integrate
from ..md.sizing import (ANG_CAP_MARGIN, BAROSTAT_SLACK, SEC_MARGIN,
                         angular_caps, ceil_to, degree_measure)
from ..md.state import BarostatState, ThermostatState
from ..models import aev as aevmod
from ..models import potential as potmod
from ..ops import aev_asn
from ..ops import cell_list as clmod
from ..ops import nbr_grad
from ..ops import neighbors as nbops
from . import domain
from .comm import LocalMesh
from .domain import AXIS_NAMES, DomainSpec

ENGINES = ("xla", "pallas_asn")
INTEGRATORS = (integrate.Langevin, integrate.NoseHoover,
               integrate.NoseHooverNPT)
# the sharded engine's own asn sizing, at the JAX package's defaults (the
# margins, the rounding and the slack shared with the single-device
# engine are md/sizing.py's)
ROLL_CAP_MARGIN = 0
ANG_TIERS = 2
ANG_TIER_MIN_N = 4096
TIER0_MARGIN = 1.15
TIER_ROWS_MARGIN = 1.5


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """The process's shards: per-atom tensors [n_local * n_cap, ...],
    shard-major in flat shard order; an empty slot has species -1 and gid
    -1. The box, the step, pe, the virial and the chains are the whole
    system's, the same on every rank."""

    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    species: torch.Tensor  # int64, -1 = empty slot
    mass: torch.Tensor
    gid: torch.Tensor  # int64 input atom index (gather, restarts)
    box: nbops.Box
    step: int
    pe: torch.Tensor  # [] kcal/mol
    virial: torch.Tensor  # [3, 3] kcal/mol
    thermostat: Optional[ThermostatState] = None
    barostat: Optional[BarostatState] = None

    def replace(self, **kw) -> "ShardedState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class _Rebuild:
    """What a chunk's rebuild froze for its steps."""

    species: torch.Tensor  # [S, n_cap]
    valid: torch.Tensor  # [S, n_cap]
    plan: domain.HaloPlan
    valid_ext: torch.Tensor  # [S, n_ext]
    species_ext: torch.Tensor  # [S, n_ext]
    bins: Optional[list] = None  # asn: RollBins per shard
    asn: Optional[list] = None  # asn: Assignment per shard
    idx: Optional[torch.Tensor] = None  # xla: [S, n_cap, k_max]
    mask: Optional[torch.Tensor] = None
    mirror: Optional[tuple] = None  # xla: (mirror, mvalid) per shard


class DomainSimulation:
    """Host orchestration of the sharded engine.

    The JAX package's signature less `devices=`: `device` (the card unless
    given), `engine` (ENGINES; None as the module docstring says),
    `pair_stage` (the asn engine's angular pair stage) and `mesh` (None:
    `LocalMesh(dspec.mesh_shape, device)`; else a mesh of
    `dspec.mesh_shape` on `device`, such as a `ProcessGroupMesh`) are the
    port's."""

    def __init__(self, potential: potmod.ANIPotential, dspec: DomainSpec,
                 cutoff: float | None = None, skin: float = 2.0,
                 rebuild_every: int = 10, dt: float = 0.5, integrator=None,
                 dtype=torch.float32, auto_angular_caps: bool = True,
                 use_brick_cells: bool | None = None,
                 mirror_force: bool = True, device=None,
                 engine: Optional[str] = None,
                 pair_stage: Optional[str] = None, mesh=None):
        if integrator is not None and not isinstance(integrator,
                                                     INTEGRATORS):
            raise TypeError(f"integrator {type(integrator).__name__}: "
                            "expected None (NVE), Langevin, NoseHoover or "
                            "NoseHooverNPT")
        self.device = resolve_device(device)
        self._engine_asked = engine
        if engine is None:
            engine = ("pallas_asn" if self.device.type == "cuda"
                      and dtype == torch.float32 else "xla")
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: expected one of {ENGINES}")
        self.pair_stage = pair_stage or "packed"
        aev_asn._check_stage(self.pair_stage)
        if engine != "pallas_asn" and self.pair_stage != "packed":
            raise ValueError(f"pair_stage {pair_stage!r} needs the "
                             "pallas_asn engine")
        self._roll_impl = engine
        self.engine = engine
        self.potential = potmod.ANIPotential(
            potential.spec, potential.params).to(device=self.device,
                                                 dtype=dtype)
        self.mirror_force = bool(mirror_force)
        self._use_brick_cells = use_brick_cells
        self._brick_grid = None  # domain.BrickGrid of the xla engine
        self._asn_grid = None  # domain.BrickRollGrid when asn runs
        self._sections = None
        self._tiers = None
        self._present_species = None
        self._auto_angular_caps = (auto_angular_caps
                                   and potential.spec.angular_caps is None)
        self.dspec = dspec
        if mesh is None:
            mesh = LocalMesh(dspec.mesh_shape, self.device)
        elif (tuple(mesh.mesh_shape) != tuple(dspec.mesh_shape)
              or _device_key(mesh.device) != _device_key(self.device)):
            raise ValueError(
                f"mesh of shape {tuple(mesh.mesh_shape)} on {mesh.device} "
                f"for an engine of dspec.mesh_shape "
                f"{tuple(dspec.mesh_shape)} on {self.device}")
        self.mesh = mesh
        self.cutoff = float(cutoff if cutoff is not None
                            else potential.spec.cutoff)
        self.skin = float(skin)
        self.rebuild_every = int(rebuild_every)
        self.dt = float(dt)
        self.integrator = integrator
        # Langevin draws from the mesh's generator of the process's shards
        self._langevin = (dataclasses.replace(
            integrator, generator=mesh.rank_generator(integrator.generator))
            if isinstance(integrator, integrate.Langevin) else None)
        self.dtype = dtype
        self.n_global = None
        self.dof = None
        self.regrow_events = 0
        self.regrow_kinds = {"mig": 0, "halo": 0, "k_max": 0, "roll": 0,
                             "sections": 0, "angular": 0, "tier_rows": 0,
                             "grid": 0}

    @property
    def rlist(self) -> float:
        """max(cutoff, Rcr) + skin: the halo margin, the neighbor radius,
        the brick bin side and the asn keep radius."""
        return max(self.cutoff, self.potential.spec.cutoff) + self.skin

    @property
    def _npt(self) -> bool:
        return isinstance(self.integrator, integrate.NoseHooverNPT)

    def _warn_fallback(self, why: str):
        if self._engine_asked == "pallas_asn":
            warnings.warn(f"engine 'pallas_asn' cannot run ({why}); the xla "
                          "engine runs instead", RuntimeWarning, stacklevel=3)

    # ---------------- host setup ----------------

    def init_state(self, species: np.ndarray, masses: np.ndarray,
                   pos: np.ndarray, box: nbops.Box,
                   vel: np.ndarray | None = None, temp: float | None = None,
                   seed: int = 12345,
                   slot: np.ndarray | None = None) -> ShardedState:
        """Shard the system: each atom to the brick of its wrapped
        fractional position, in input order within a shard; the state
        keeps the process's shards. Every rank takes the whole system's
        arrays. Velocities: given, drawn over every atom at `temp` from
        `seed` (the same draw on every rank), or zero. `slot` (a restart's:
        each atom's flat row, shard * n_cap + slot) lays the atoms out as
        given instead, their positions as they are (the next rebuild
        wraps and migrates them)."""
        species = np.asarray(species, np.int64)
        masses = np.asarray(masses, np.float64)
        n = len(species)
        self.n_global = n
        self.dof = 3 * n - 3
        box = box.to(device=self.device, dtype=self.dtype)
        box_h = box.h.detach().cpu().numpy().astype(np.float64)
        perp = domain.perp_lengths(box_h)
        for a in range(3):
            extent = perp[a] / self.dspec.mesh_shape[a]
            if extent < self.rlist:
                raise ValueError(
                    f"brick extent {extent:.2f} A along {AXIS_NAMES[a]} < "
                    f"rlist {self.rlist:.2f} A; use fewer shards or a "
                    "bigger box")
        pos_t = nbops.wrap_positions(
            torch.as_tensor(np.asarray(pos), dtype=self.dtype,
                            device=self.device), box)
        species_t = torch.as_tensor(species, device=self.device)
        self._present_species = tuple(int(s) for s in np.unique(species)
                                      if s >= 0)
        use_cells = (self._use_brick_cells
                     if self._use_brick_cells is not None
                     else self.dspec.n_cap >= 2048)
        self._brick_grid = None
        if use_cells:
            self._setup_brick_grid(n, box_h)
        self.engine = "xla"
        self._asn_grid = None
        if self._roll_impl == "pallas_asn":
            if not (self._auto_angular_caps
                    or self.potential.spec.angular_caps is not None):
                self._warn_fallback("no angular caps and auto_angular_caps "
                                    "is off")
            elif self._setup_asn(pos_t, species_t, box):
                self.engine = "pallas_asn"
            else:
                self._warn_fallback("a brick holds no bin of side "
                                    f"{self.rlist:.3f} A")
        if self._auto_angular_caps and self.engine == "xla":
            caps = _measure_angular_caps(self.potential.spec, pos_t,
                                         species_t, box)
            self.potential = self.potential.with_spec(dataclasses.replace(
                self.potential.spec, angular_caps=caps))
        if vel is None:
            if temp is not None:
                g = torch.Generator(device="cpu").manual_seed(seed)
                vel = integrate.create_velocities(
                    g, torch.as_tensor(masses, dtype=self.dtype), temp,
                    self.dof).numpy()
            else:
                vel = np.zeros((n, 3))

        ns, cap = self.dspec.n_shards, self.dspec.n_cap
        if slot is None:
            row = self._rows_of(box, pos_t)
            pos_host = pos_t.detach().cpu().numpy()
        else:
            row = np.asarray(slot, np.int64)
            if (row.shape != (n,) or len(np.unique(row)) != n
                    or row.min() < 0 or row.max() >= ns * cap):
                raise ValueError(f"slot: expected {n} distinct rows in "
                                 f"[0, {ns * cap})")
            pos_host = np.asarray(pos, np.float64)
        center = (box.origin + 0.5 * box.h.sum(dim=0)).detach().cpu().numpy()
        gpos = np.tile(center.astype(np.float64), (ns * cap, 1))
        gpos[row] = pos_host
        gvel = np.zeros((ns * cap, 3))
        gvel[row] = np.asarray(vel, np.float64)
        gspecies = np.full(ns * cap, -1, np.int64)
        gspecies[row] = species
        gmass = np.ones(ns * cap)
        gmass[row] = masses
        ggid = np.full(ns * cap, -1, np.int64)
        ggid[row] = np.arange(n)
        # the process's shards
        mine = (np.asarray(self.mesh.local_shards)[:, None] * cap
                + np.arange(cap)).ravel()

        def dev(x, dt=None):
            return torch.as_tensor(x, dtype=dt or self.dtype,
                                   device=self.device)

        ts = bs = None
        if self._npt:
            ts = self.integrator.thermostat.init(self.dtype, self.device)
            bs = self.integrator.init(self.dtype, self.device)
        elif isinstance(self.integrator, integrate.NoseHoover):
            ts = self.integrator.init(self.dtype, self.device)
        state = ShardedState(
            pos=dev(gpos[mine]), vel=dev(gvel[mine]),
            force=torch.zeros((len(mine), 3), dtype=self.dtype,
                              device=self.device),
            species=dev(gspecies[mine], torch.int64), mass=dev(gmass[mine]),
            gid=dev(ggid[mine], torch.int64), box=box, step=0,
            pe=torch.zeros((), dtype=self.dtype, device=self.device),
            virial=torch.zeros((3, 3), dtype=self.dtype, device=self.device),
            thermostat=ts, barostat=bs)
        if self._asn_grid is not None:
            self._probe_asn_cap(state)
        return state

    def _rows_of(self, box, pos_wrapped) -> np.ndarray:
        """[n] each atom's flat row: the shard of its fractional
        coordinates, input order within a shard."""
        frac = box.to_fractional(pos_wrapped).detach().cpu().numpy().astype(
            np.float64)
        frac = np.clip(frac, 0.0, np.nextafter(1.0, 0.0))
        shape = np.asarray(self.dspec.mesh_shape)
        sc = np.minimum((frac * shape).astype(np.int64), shape - 1)
        shard = (sc[:, 0] * shape[1] + sc[:, 1]) * shape[2] + sc[:, 2]
        ns, cap = self.dspec.n_shards, self.dspec.n_cap
        counts = np.bincount(shard, minlength=ns)
        if counts.max() > cap:
            raise ValueError(f"shard occupancy {counts.max()} > n_cap {cap}")
        order = np.argsort(shard, kind="stable")
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(len(shard), np.int64)
        slot[order] = np.arange(len(shard)) - start[shard[order]]
        return shard * cap + slot

    def _setup_brick_grid(self, n, box_h):
        """(Re-)derive the xla engine's per-brick cell grid from the box as
        it is, with slack under NoseHooverNPT (the slack inflates the cell
        side and the halo margin, so a box shrink below it keeps the
        frozen fractions covering rlist)."""
        slack = BAROSTAT_SLACK if self._npt else 1.0
        density = n / float(abs(np.linalg.det(np.asarray(box_h))))
        cap = ceil_to(int(self.rlist ** 3 * density * 2.0 + 4), 8)
        old = self._brick_grid
        self._brick_grid = domain.BrickGrid.for_box(
            np.asarray(box_h), self.dspec.mesh_shape, self.rlist * slack,
            max(cap, old.cell_capacity if old else 0))

    def _asn_grid_valid(self, box_h) -> bool:
        """Whether the frozen brick bins still cover rlist in the
        (barostat-rescaled) box: margin and bin side are box fractions."""
        g = self._asn_grid
        if g is None:
            return True
        perp = domain.perp_lengths(box_h)
        return not any(g.margin_frac[a] * perp[a] < self.rlist
                       or g.cell_frac[a] * perp[a] < self.rlist
                       for a in range(3))

    def _brick_grid_valid(self, box_h) -> bool:
        """Whether the frozen cell grid still covers rlist in the box."""
        g = self._brick_grid
        if g is None:
            return True
        perp = domain.perp_lengths(box_h)
        for a in range(3):
            margin = g.margin_frac[a] * perp[a]
            if margin < self.rlist:
                return False
            brick = perp[a] / self.dspec.mesh_shape[a]
            if (brick + 2.0 * margin) / g.ncells[a] < self.rlist:
                return False
        return True

    def _setup_asn(self, pos, species, box) -> bool:
        """The brick bins' geometry, the compact sections, the angular caps
        and the tiers of the asn engine from one degree measure over the
        whole system (the same numbers on every shard). False, and the
        xla engine, where a brick holds no bin of side rlist. A re-derive
        (under a barostat) never shrinks a section or a cap."""
        box_h = box.h.detach().cpu().numpy().astype(np.float64)
        slack = BAROSTAT_SLACK if self._npt else 1.0
        grid = domain.BrickRollGrid.for_box(
            box_h, self.dspec.mesh_shape, self.rlist * slack,
            self.rlist * slack, cap=8)
        if grid is None:
            self._asn_grid = None
            return False
        spec = self.potential.spec
        rad_degs, ang_degs, cnt = _measure_asn_degrees(spec, pos, species,
                                                       box, self.rlist)
        sections = aev_asn.sections_from_degrees(rad_degs, SEC_MARGIN)
        if self._sections is not None:
            old = dict(self._sections)
            sections = tuple((s, max(k, old.get(s, 0))) for s, k in sections)
        self._sections = sections
        caps = angular_caps(ang_degs, ANG_CAP_MARGIN)
        if spec.angular_caps is not None:
            # the spec's caps, or a re-derive's, never shrink
            caps = tuple(max(c, o) if c else 0
                         for c, o in zip(caps, spec.angular_caps))
        self.potential = self.potential.with_spec(
            dataclasses.replace(spec, angular_caps=caps))
        self._tiers = self._derive_tiers_sharded(
            np.asarray(cnt), self.potential.spec.angular_caps)
        self._asn_grid = grid
        return True

    def _derive_tiers_sharded(self, cnt, caps):
        """Two occupancy tiers from the GLOBAL degree matrix `cnt` [n, S]:
        tier-0 caps are composition statistics (the same on every shard);
        the row capacities scale the global fit count to n_cap with margin
        (empty slots count as tier-0 rows). A shard of unusual
        composition spills to the last tier, whose shortfall is a regrow.
        None below ANG_TIER_MIN_N slots a shard or where one tier is as
        good."""
        if ANG_TIERS < 2 or self.dspec.n_cap < ANG_TIER_MIN_N:
            return None
        res = aev_asn.search_tiers(cnt, caps, self.pair_stage)
        if res is None:
            return None
        caps0, n0 = res
        n = cnt.shape[0]
        n_cap, ns = self.dspec.n_cap, self.dspec.n_shards
        rows0 = min(int(n0 / n * n_cap * TIER0_MARGIN)
                    + (n_cap - n // ns) + 128, n_cap)
        rows1 = min(int((n - n0) / ns * TIER_ROWS_MARGIN) + 256, n_cap)
        return ((tuple(caps0), rows0), (tuple(caps), rows1))

    @property
    def kpad(self) -> int:
        """asn: compact lanes per center (the sections and a dead lane,
        rounded up to 128)."""
        return aev_asn._round_lane(sum(k for _, k in self._sections) + 1)

    def _views(self, state):
        s, cap = self.mesh.n_local, self.dspec.n_cap
        return (state.pos.reshape(s, cap, 3), state.species.reshape(s, cap),
                (state.species >= 0).reshape(s, cap))

    def _probe_asn_cap(self, state):
        """Set the bin cap to the measured occupancy of every shard's
        brick bins (+2, +ROLL_CAP_MARGIN, rounded to 4): the cap sets every
        asn kernel's window."""
        pos, species, valid = self._views(state)
        with torch.no_grad():
            plan = domain.build_halo_plan(self.mesh, self.dspec, pos,
                                          species, valid, state.box,
                                          self.rlist)
            pos_ext = domain.halo_positions(self.mesh, self.dspec, pos,
                                            state.box, plan)
            bins = domain.build_bins_brick(
                self.mesh, self._asn_grid, pos_ext,
                plan.ext_species(species), plan.ext_valid(valid), state.box)
        cnt = int(self.mesh.pmax(torch.stack([b.count_max for b in bins])))
        self._asn_grid = dataclasses.replace(
            self._asn_grid, cap=ceil_to(cnt + 2 + ROLL_CAP_MARGIN, 4))

    def sizing(self) -> dict:
        """What the engine derived and grew, and the mesh it runs on (its
        backend, the shards a process holds), JSON-able."""
        spec = self.potential.spec
        g, bg, d = self._asn_grid, self._brick_grid, self.dspec
        return {
            "engine": self.engine, "mesh_shape": list(d.mesh_shape),
            "backend": self.mesh.backend, "n_local": self.mesh.n_local,
            "n_cap": d.n_cap, "halo_cap": list(d.halo_cap),
            "mig_cap": d.mig_cap, "k_max": d.k_max, "rlist": self.rlist,
            "angular_caps": (None if spec.angular_caps is None
                             else list(spec.angular_caps)),
            "brick_bins": None if g is None else [list(g.ncells), g.cap],
            "brick_cells": None if bg is None else [list(bg.ncells),
                                                    bg.cell_capacity],
            "sections": (None if self._sections is None
                         else [list(x) for x in self._sections]),
            "kpad": None if self._sections is None else self.kpad,
            "tiers": (None if self._tiers is None
                      else [[list(c), r] for c, r in self._tiers]),
            "pair_stage": self.pair_stage}

    def _restore_sizing(self, d: dict):
        """Take the engine's part of the sizing `d` that `sizing()` gave (a
        restart's, for the engine `init_state` chose): the bin and cell
        caps, the sections, the tiers and the angular caps. The grids'
        geometry stays the box's; `load_restart` sets the capacities
        before the layout."""
        caps = d["angular_caps"]
        self.potential = self.potential.with_spec(dataclasses.replace(
            self.potential.spec,
            angular_caps=None if caps is None else tuple(caps)))
        if self._asn_grid is not None and d["brick_bins"] is not None:
            self._asn_grid = dataclasses.replace(self._asn_grid,
                                                 cap=d["brick_bins"][1])
        if self._brick_grid is not None and d["brick_cells"] is not None:
            self._brick_grid = dataclasses.replace(
                self._brick_grid, cell_capacity=d["brick_cells"][1])
        self._sections = (None if d["sections"] is None
                          else tuple(tuple(x) for x in d["sections"]))
        self._tiers = (None if d["tiers"] is None
                       else tuple((tuple(c), r) for c, r in d["tiers"]))

    # ---------------- the rebuild and the steps ----------------

    def _rebuild(self, state: ShardedState):
        """Migrate, plan the halo and build each shard's structure at the
        state's positions. Returns (payload, rebuild, overflow codes as
        device tensors)."""
        d, mesh, box = self.dspec, self.mesh, state.box
        s, cap = mesh.n_local, d.n_cap
        pos = nbops.wrap_positions(state.pos, box).reshape(s, cap, 3)
        valid = (state.species >= 0).reshape(s, cap)
        payload = {"pos": pos, "vel": state.vel.reshape(s, cap, 3),
                   "species": state.species.reshape(s, cap),
                   "mass": state.mass.reshape(s, cap),
                   "gid": state.gid.reshape(s, cap)}
        payload, valid, mig = domain.migrate(mesh, d, payload, valid, box)
        payload["mass"] = torch.where(valid, payload["mass"], 1.0)
        pos, species = payload["pos"], payload["species"]
        plan = domain.build_halo_plan(mesh, d, pos, species, valid, box,
                                      self.rlist)
        pos_ext = domain.halo_positions(mesh, d, pos, box, plan)
        sp_ext, v_ext = plan.ext_species(species), plan.ext_valid(valid)
        rb = _Rebuild(species=species, valid=valid, plan=plan,
                      valid_ext=v_ext, species_ext=sp_ext)
        pmax = self.mesh.pmax
        codes = {"mig": pmax(mig), "halo": pmax(plan.overflow)}
        if self.engine == "pallas_asn":
            grid = self._asn_grid
            rb.bins = domain.build_bins_brick(mesh, grid, pos_ext, sp_ext,
                                              v_ext, box)
            rb.asn = [aev_asn.build_assignment(
                grid.roll, b, pos_ext[i], box, self._sections, self.kpad,
                self.rlist) for i, b in enumerate(rb.bins)]
            codes["roll_count"] = pmax(torch.stack(
                [b.count_max for b in rb.bins]))
            codes["roll"] = codes["roll_count"] > grid.cap
            codes["sec_deficit"] = pmax(torch.stack(
                [a.ovf_sec for a in rb.asn]))
            codes["sections"] = codes["sec_deficit"].max() > 0
        else:
            self._rebuild_xla(rb, pos, valid, pos_ext, box, codes)
        return payload, rb, codes

    def _rebuild_xla(self, rb, pos, valid, pos_ext, box, codes):
        d, mesh = self.dspec, self.mesh
        v_ext = rb.valid_ext
        if self._brick_grid is not None:
            idx, mask, max_deg = domain.build_neighbor_matrix_brick(
                mesh, d, self._brick_grid, pos, valid, pos_ext, v_ext, box,
                self.rlist, d.k_max)
        else:
            idx, mask, max_deg = domain.build_neighbor_matrix_ext(
                pos, valid, pos_ext, v_ext, self.rlist, d.k_max)
        rb.idx, rb.mask = idx, mask
        pmax = mesh.pmax
        k_ovf = pmax(max_deg > d.k_max)
        if self.mirror_force:
            if self._brick_grid is not None:
                eidx, emask, ext_deg = domain.build_ext_rows_brick(
                    mesh, d, self._brick_grid, pos, valid, pos_ext, v_ext,
                    box, self.rlist, d.k_max)
            else:
                eidx, emask, ext_deg = domain.build_ext_rows(
                    pos, valid, pos_ext, v_ext, self.rlist, d.k_max)
            tables = [nbr_grad.build_mirror_ext(idx[i], mask[i], eidx[i],
                                                emask[i])
                      for i in range(mesh.n_local)]
            rb.mirror = [(m, mv) for m, mv, _ in tables]
            missing = pmax(~torch.stack([t[2] for t in tables]))
            # a k_max regrow regrows the ext rows with it
            k_ovf = k_ovf | pmax(ext_deg > d.k_max) | missing
        codes["k_max"] = k_ovf
        caps = self.potential.spec.angular_caps
        codes["angular"] = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
        if caps is not None:
            # the blocked angular AEV: the caps must cover each shard's
            # degrees at the rebuild
            worst = []
            for i in range(mesh.n_local):
                dd = torch.where(mask[i][..., None],
                                 pos[i][:, None, :] - pos_ext[i][idx[i]], 1.0)
                dist = torch.where(mask[i], torch.linalg.norm(dd, dim=-1),
                                   1e6)
                sp_j = torch.where(mask[i], rb.species_ext[i][idx[i]], -1)
                worst.append(aevmod.angular_cap_deficit(
                    self.potential.spec.aev, dist, sp_j,
                    mask[i] & (sp_j >= 0), caps))
            codes["angular"] = pmax(torch.stack(worst)) > 0

    def _forces(self, pos, box, rb: _Rebuild):
        """(pe, force [n_local * n_cap, 3], virial, deficit) in kcal/mol
        units; pe, the virial and the deficit are the whole system's.

        The process's shards' summed energy is differentiated through the
        halo exchange: the sum over every process is the system's (each
        atom's energy counted once, on its owner), and the shifts'
        backwards carry every ghost's force home, so the gradient with
        respect to the owned positions is each atom's whole force. pe and
        the strain gradient of the virial (positions and box strained
        additively) are then summed over the mesh, outside autograd."""
        d = self.dspec
        s, cap = self.mesh.n_local, d.n_cap
        pot = self.potential
        asn = self.engine == "pallas_asn"
        with torch.enable_grad():
            eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                              requires_grad=True)
            pos_ = pos.detach().reshape(s, cap, 3).requires_grad_(True)
            h = box.h.detach()
            p_d = pos_ + pos_ @ eps
            box_d = nbops.Box(h=h + h @ eps, origin=box.origin)
            pos_ext = domain.halo_positions(self.mesh, d, p_d, box_d,
                                            rb.plan)
            if asn:
                # empty slots sit at finite parking positions: stop their
                # cotangents, so the duplicate (0, 0) slots of the brick
                # bins carry no force or virial
                pos_ext = torch.where(rb.valid_ext[..., None], pos_ext,
                                      pos_ext.detach())
            energies, deficits = [], []
            for i, (p_i, ext_i) in enumerate(zip(p_d.unbind(0),
                                                 pos_ext.unbind(0))):
                if asn:
                    e_at, deficit = potmod.atomic_energies_asn(
                        pot, rb.species[i], ext_i, box_d,
                        (self._asn_grid.roll, rb.bins[i], rb.asn[i],
                         self._sections, self._tiers, self.pair_stage),
                        None, present_species=self._present_species,
                        local_mask=rb.valid[i], n_out=cap)
                    deficits.append(deficit)
                else:
                    e_at = potmod.atomic_energies_ext(
                        pot, rb.species[i], p_i, ext_i, rb.species_ext[i],
                        rb.idx[i], rb.mask[i], local_mask=rb.valid[i],
                        present_species=self._present_species,
                        mirror_ext=(rb.mirror[i] if rb.mirror is not None
                                    else None))
                energies.append(e_at.sum())
            energies = torch.stack(energies)
            deps, dpos = torch.autograd.grad(energies.sum(), (eps, pos_))
        energy = self.mesh.psum(energies.detach())
        deps = self.mesh.psum(deps[None])
        c = units.HARTREE2KCALMOL
        deficit = (self.mesh.pmax(torch.stack(deficits)) if deficits
                   else torch.zeros((1,), dtype=pos.dtype,
                                    device=pos.device))
        return (energy * c, -dpos.reshape(s * cap, 3) * c,
                -0.5 * (deps + deps.T) * c, deficit)

    def _kinetic(self, vel, mass, valid):
        """(kinetic energy, kinetic tensor [3, 3], mass) of the whole
        system, in one reduction over the mesh of each shard's sums (one
        shard's sums are the same bits on either backend, so a mesh of two
        ranks gives `LocalMesh`'s bits: a sum of two is exact in either
        order)."""
        s = self.mesh.n_local
        parts = []
        for v, w, ok in zip(vel.reshape(s, -1, 3).unbind(0),
                            mass.reshape(s, -1).unbind(0),
                            valid.reshape(s, -1).unbind(0)):
            m = torch.where(ok, w, 0.0)
            kin = units.MVV2E * torch.einsum("i,ia,ib->ab", m, v, v)
            parts.append(torch.cat([integrate.kinetic_energy(v, w, ok)[None],
                                    torch.sum(m)[None], kin.reshape(9)]))
        tot = self.mesh.psum(torch.stack(parts))
        return tot[0], tot[2:].reshape(3, 3), tot[1]

    @staticmethod
    def _pressure(kin, virial, box):
        """[] the pressure in atm from the whole system's kinetic tensor
        and virial."""
        return torch.trace((kin + virial) / box.volume * units.NKTV2P) / 3.0

    def _chunk(self, state: ShardedState, n_take: int):
        """One rebuild and up to n_take steps; stops early (before
        stepping) once an atom has moved more than skin/2 since the
        rebuild. Returns (state, thermo [k, 6], max displacement, overflow,
        steps done); `overflow` is empty when every capacity held, else
        names what to grow (with "roll_count", "sec_deficit" and
        "deficit", the measured sizes)."""
        payload, rb, codes = self._rebuild(state)
        overflow = _read_overflow(codes)
        if overflow:
            return None, None, 0.0, overflow, 0

        s, cap = self.mesh.n_local, self.dspec.n_cap
        valid = rb.valid.reshape(-1)
        vmask = valid[:, None]
        mass = payload["mass"].reshape(-1)
        pos = payload["pos"].reshape(-1, 3)
        vel = payload["vel"].reshape(-1, 3)
        box = state.box
        pe, force, virial, deficit = self._forces(pos, box, rb)
        pos_rebuild = pos
        npt = self.integrator if self._npt else None
        nh = (self.integrator if isinstance(self.integrator,
                                            integrate.NoseHoover) else None)
        lang = self._langevin
        dt, dof, n = self.dt, self.dof, self.n_global
        ts, bs = state.thermostat, state.barostat
        half_skin = self.skin / 2.0

        def kinetic(v):
            return self._kinetic(v, mass, valid)

        def displacement():
            """The largest displacement since the rebuild, over the mesh."""
            moved = torch.linalg.norm(
                torch.where(vmask, pos - pos_rebuild, 0.0), dim=-1)
            return float(self.mesh.pmax(moved.reshape(s, cap).max(1).values))

        rows, deficits = [], [deficit]
        disp = 0.0
        n_done = 0
        for _ in range(n_take):
            disp = displacement()
            if disp > half_skin:
                break
            if npt is not None:
                ke, kin, _ = kinetic(vel)
                bs = npt.piston_half(bs, self._pressure(kin, virial, box),
                                     box.volume, ke, n, dt, dof)
                ts, vel = npt.thermostat.half_step(ts, vel, mass, dof, dt,
                                                   ke2=2.0 * ke)
                vel = vel * npt.vel_scale(bs.omega, dof, n, dt)
            elif nh is not None:
                ts, vel = nh.half_step(ts, vel, mass, dof, dt,
                                       ke2=2.0 * kinetic(vel)[0])
            vel = integrate.nve_halfkick(vel, force, mass, dt)
            if npt is not None:
                sc = npt.box_scale(bs.omega, dt)
                box = integrate.rescale_box(box, sc)
                pos = box.origin + (pos - box.origin) * sc
            pos = integrate.nve_drift(pos, vel, dt)
            pos = torch.where(vmask, pos, pos_rebuild)
            pe, force, virial, deficit = self._forces(pos, box, rb)
            deficits.append(deficit)
            if lang is not None:
                force = force + torch.where(
                    vmask, lang.force(vel, mass, dt), 0.0)
            vel = integrate.nve_halfkick(vel, force, mass, dt)
            if npt is not None:
                vel = vel * npt.vel_scale(bs.omega, dof, n, dt)
                ts, vel = npt.thermostat.half_step(
                    ts, vel, mass, dof, dt, ke2=2.0 * kinetic(vel)[0])
                ke, kin, _ = kinetic(vel)
                bs = npt.piston_half(bs, self._pressure(kin, virial, box),
                                     box.volume, ke, n, dt, dof)
            elif nh is not None:
                ts, vel = nh.half_step(ts, vel, mass, dof, dt,
                                       ke2=2.0 * kinetic(vel)[0])
            vel = torch.where(vmask, vel, 0.0)
            ke, kin, m_tot = kinetic(vel)
            vol = box.volume
            rows.append(torch.stack([
                pe, ke, 2.0 * ke / (dof * units.BOLTZ),
                self._pressure(kin, virial, box), vol,
                m_tot / units.AVOGADRO_VOL / vol]))
            n_done += 1
        if deficits:
            worst = torch.stack(deficits).max(0).values.cpu().numpy()
            if worst.max() > 0:
                overflow["angular"] = True
                overflow["deficit"] = worst
                return None, None, disp, overflow, 0
        disp = displacement()
        new_state = ShardedState(
            pos=pos, vel=vel, force=force, species=rb.species.reshape(-1),
            mass=mass, gid=payload["gid"].reshape(-1), box=box,
            step=state.step + n_done, pe=pe, virial=virial, thermostat=ts,
            barostat=bs)
        return (new_state, torch.stack(rows) if rows else None, disp, {},
                n_done)

    # ---------------- host API ----------------

    _THERMO_KEYS = ("pe", "ke", "temp", "press", "vol", "density")

    def run(self, state: ShardedState, n_steps: int,
            thermo_every: int | None = None,
            thermo_callback: Optional[Callable] = None):
        """Advance n_steps. Returns (state, thermo rows); rows carry step
        pe ke etotal temp press vol density."""
        rows = []
        done = 0
        recap_attempts = 0
        while done < n_steps:
            if self._npt:
                self._revalidate_grids(state)
            take = min(self.rebuild_every, n_steps - done)
            new_state, thermo, disp, overflow, n_done = self._chunk(state,
                                                                    take)
            if overflow:
                recap_attempts += 1
                self.regrow_events += 1
                if recap_attempts > 8:
                    raise RuntimeError("sharded capacities keep overflowing "
                                       f"after 8 regrows: {overflow}")
                self._regrow(state, overflow)
                continue
            recap_attempts = 0
            if n_done == 0:
                raise RuntimeError(
                    f"atoms moved {disp:.3f} A > skin/2 ({self.skin / 2:.2f})"
                    " in ONE step: raise skin or lower dt")
            state = new_state
            if self._npt:
                # the box is the same bits on every rank
                perp = domain.perp_lengths(
                    state.box.h.detach().cpu().numpy())
                extents = perp / np.asarray(self.dspec.mesh_shape)
                if (extents < self.rlist).any():
                    raise RuntimeError(
                        f"NPT shrank brick extents to {extents} A < rlist "
                        f"{self.rlist:.2f} A; use fewer shards")
            if thermo_every:
                th = thermo.detach().cpu().numpy()
                for k in range(n_done):
                    step = done + k + 1
                    if step % thermo_every == 0 or step == n_steps:
                        row = {f: float(th[k, i])
                               for i, f in enumerate(self._THERMO_KEYS)}
                        row["step"] = step
                        row["etotal"] = row["pe"] + row["ke"]
                        rows.append(row)
                        if thermo_callback:
                            thermo_callback(row)
            done += n_done
        return state, rows

    def evaluate(self, state: ShardedState) -> ShardedState:
        """The state after a rebuild (migration included) with pe, force
        and virial at its positions; no step. Capacities that overflow at
        the rebuild, or in the force evaluation (an angular cap, the last
        tier's rows), grow and the evaluation runs again, as in `run`."""
        for _ in range(9):
            payload, rb, codes = self._rebuild(state)
            ovf = _read_overflow(codes)
            if not ovf:
                pos = payload["pos"].reshape(-1, 3)
                pe, force, virial, deficit = self._forces(pos, state.box, rb)
                worst = deficit.cpu().numpy()
                if worst.max() <= 0:
                    break
                ovf = {"angular": True, "deficit": worst}
            self.regrow_events += 1
            self._regrow(state, ovf)
        else:
            raise RuntimeError(f"capacities keep overflowing: {ovf}")
        return state.replace(
            pos=pos, vel=payload["vel"].reshape(-1, 3), force=force,
            species=rb.species.reshape(-1), mass=payload["mass"].reshape(-1),
            gid=payload["gid"].reshape(-1), pe=pe, virial=virial)

    def _revalidate_grids(self, state):
        """Under NoseHooverNPT: re-derive a brick grid the box has left."""
        bh = state.box.h.detach().cpu().numpy().astype(np.float64)
        if self._brick_grid is not None and not self._brick_grid_valid(bh):
            self._setup_brick_grid(self.n_global, bh)
            self.regrow_kinds["grid"] += 1
            self.regrow_events += 1
        if self._asn_grid is not None and not self._asn_grid_valid(bh):
            pos, species = self._gathered(state)
            if self._setup_asn(pos, species, state.box):
                self._probe_asn_cap(state)
            else:
                self.engine = "xla"
                if self._auto_angular_caps:
                    self._derive_caps_sharded(state)
            self.regrow_kinds["grid"] += 1
            self.regrow_events += 1

    def _regrow(self, state, ovf: dict):
        """Grow exactly the capacities `ovf` names (never down)."""
        d = self.dspec
        if ovf.get("mig"):
            d = dataclasses.replace(d, mig_cap=int(d.mig_cap * 3 // 2) + 8)
            self.regrow_kinds["mig"] += 1
        if ovf.get("halo"):
            d = dataclasses.replace(d, halo_cap=tuple(
                int(c * 3 // 2) + 8 for c in d.halo_cap))
            self.regrow_kinds["halo"] += 1
        if ovf.get("k_max"):
            d = dataclasses.replace(d, k_max=ceil_to(d.k_max * 3 // 2, 8))
            if self._brick_grid is not None:
                self._brick_grid = dataclasses.replace(
                    self._brick_grid, cell_capacity=ceil_to(
                        self._brick_grid.cell_capacity * 3 // 2, 8))
            self.regrow_kinds["k_max"] += 1
        self.dspec = d
        if ovf.get("roll"):
            # to the measured occupancy: the cap sets every kernel's window
            new_cap = max(ceil_to(ovf["roll_count"] + 2, 4),
                          self._asn_grid.cap + 4)
            self._asn_grid = dataclasses.replace(self._asn_grid, cap=new_cap)
            self.regrow_kinds["roll"] += 1
        if ovf.get("sections"):
            # exactly the overflowing sections, by their deficits (a
            # re-measure at the chunk's input state could give back the
            # sections that just overflowed)
            dv = ovf["sec_deficit"]
            self._sections = tuple(
                (s, k + max(4, ceil_to(dv[s], 4))
                 if s < len(dv) and dv[s] > 0 else k)
                for s, k in self._sections)
            self.regrow_kinds["sections"] += 1
        if ovf.get("angular"):
            if self.engine == "pallas_asn":
                # the kernels' per-species deficits, and the last tier's
                # missing rows (the trailing entry where tiered)
                dv = ovf["deficit"]
                spec = self.potential.spec
                nsp = spec.aev.num_species
                caps = tuple(c if (c == 0 or dd <= 0)
                             else c + max(4, ceil_to(dd, 4))
                             for c, dd in zip(spec.angular_caps, dv[:nsp]))
                if caps != spec.angular_caps:
                    self.potential = self.potential.with_spec(
                        dataclasses.replace(spec, angular_caps=caps))
                    self.regrow_kinds["angular"] += 1
                if self._tiers is not None:
                    last_rows = self._tiers[-1][1]
                    if len(dv) > nsp and dv[nsp] > 0:
                        last_rows += max(256, int(dv[nsp] * 1.5))
                        self.regrow_kinds["tier_rows"] += 1
                    self._tiers = self._tiers[:-1] + ((caps, last_rows),)
            else:
                self._derive_caps_sharded(state)
                self.regrow_kinds["angular"] += 1

    def _derive_caps_sharded(self, state: ShardedState):
        """Re-measure the angular degrees at the state's positions and
        grow the caps (margin 1.5)."""
        pos, species = self._gathered(state)
        caps = _measure_angular_caps(self.potential.spec, pos, species,
                                     state.box, margin=1.5)
        self.potential = self.potential.with_spec(dataclasses.replace(
            self.potential.spec, angular_caps=caps))

    def _gathered(self, state):
        """(positions, species) of the whole system as device tensors in
        input order."""
        pos = torch.as_tensor(self.gather(state, "pos"), dtype=self.dtype,
                              device=self.device)
        species = torch.as_tensor(self.gather(state, "species"),
                                  device=self.device)
        return nbops.wrap_positions(pos, state.box), species

    def _whole(self, x: torch.Tensor) -> np.ndarray:
        """[n_shards * n_cap, ...] on the host: a per-slot tensor of the
        process's shards, all-gathered in flat shard order (collective)."""
        s, cap = self.mesh.n_local, self.dspec.n_cap
        x = x.detach().reshape((s, cap) + tuple(x.shape[1:]))
        return self.mesh.all_gather(x).reshape(
            (-1,) + tuple(x.shape[2:])).cpu().numpy()

    def layout(self, state: ShardedState) -> np.ndarray:
        """[n_shards * n_cap] the gid of every slot of the mesh, -1 where
        empty (collective: every rank calls it)."""
        return self._whole(state.gid)

    def gather(self, state: ShardedState, field: str) -> np.ndarray:
        """A per-atom field of the whole system on the host, in input atom
        order (through the mesh's all-gather: every rank calls it)."""
        gid = self.layout(state)
        arr = self._whole(getattr(state, field))
        ok = gid >= 0
        out = np.zeros((self.n_global,) + arr.shape[1:], arr.dtype)
        out[gid[ok]] = arr[ok]
        return out

    def save_restart(self, path, state: ShardedState):
        """The state in input atom order, under the JAX package's npz keys
        (its `DomainSimulation.load_restart` reads it, and this one reads
        the JAX package's), and two the JAX package does not read: `slot`
        (each atom's flat row, shard * n_cap + slot) and the engine's
        sizing in the metadata, with which `load_restart` resumes the run
        bit for bit. Every rank calls it; rank 0 writes."""
        gid = self.layout(state)
        ok = gid >= 0
        slot = np.empty(self.n_global, np.int64)
        slot[gid[ok]] = np.flatnonzero(ok)
        arrays = {k: self.gather(state, k)
                  for k in ("pos", "vel", "species", "mass")}
        arrays["slot"] = slot
        arrays["species"] = arrays["species"].astype(np.int32)
        arrays.update(
            box_h=state.box.h.detach().cpu().numpy(),
            box_origin=state.box.origin.detach().cpu().numpy(),
            step=np.asarray(state.step, np.int32))
        if state.thermostat is not None:
            arrays["ts_eta"] = state.thermostat.eta.cpu().numpy()
            arrays["ts_eta_dot"] = state.thermostat.eta_dot.cpu().numpy()
        if state.barostat is not None:
            arrays["bs_omega"] = state.barostat.omega.cpu().numpy()
            arrays["bs_eta"] = state.barostat.omega_chain.eta.cpu().numpy()
            arrays["bs_eta_dot"] = (
                state.barostat.omega_chain.eta_dot.cpu().numpy())
        meta = {"n_atoms": self.n_global, "dt": self.dt,
                "sizing": self.sizing()}
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8)
        if self.mesh.rank == 0:
            np.savez(path, **arrays)

    def load_restart(self, path) -> ShardedState:
        """A state from `save_restart`'s npz (or the JAX package's); every
        rank reads the file and keeps its shards. A file of this engine's
        mesh shape with its `slot` and sizing gives back the layout and
        the sizing (that of the engine `init_state` chooses), so the run
        resumes bit for bit; otherwise the atoms are laid out from input
        order and the sizing derived anew, as the JAX engine does."""
        with np.load(path) as z:
            z = {k: z[k] for k in z.files}

        def dev(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        meta = json.loads(bytes(z["__meta__"]).decode()) if (
            "__meta__" in z) else {}
        sizing = meta.get("sizing")
        own = ("slot" in z and sizing is not None and tuple(
            sizing["mesh_shape"]) == tuple(self.dspec.mesh_shape))
        if own:
            self.dspec = dataclasses.replace(
                self.dspec, n_cap=sizing["n_cap"],
                halo_cap=tuple(sizing["halo_cap"]),
                mig_cap=sizing["mig_cap"], k_max=sizing["k_max"])
        box = nbops.Box(h=dev(z["box_h"]), origin=dev(z["box_origin"]))
        state = self.init_state(z["species"], z["mass"], z["pos"], box,
                                vel=z["vel"],
                                slot=z["slot"] if own else None)
        if own and sizing["engine"] == self.engine:
            self._restore_sizing(sizing)
        ts, bs = state.thermostat, state.barostat
        if "ts_eta" in z and ts is not None:
            ts = ThermostatState(eta=dev(z["ts_eta"]),
                                 eta_dot=dev(z["ts_eta_dot"]))
        if "bs_omega" in z and bs is not None:
            bs = BarostatState(omega=dev(z["bs_omega"]),
                               omega_chain=ThermostatState(
                                   eta=dev(z["bs_eta"]),
                                   eta_dot=dev(z["bs_eta_dot"])))
        return state.replace(step=int(z["step"]), thermostat=ts,
                             barostat=bs)


def _device_key(device) -> tuple:
    """(type, index) of a device, a card without an index as the current
    one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def _read_overflow(codes) -> dict:
    """The rebuild's overflow codes on the host (one read): the kinds
    that overflowed, with the measured bin count and section deficits
    where those did."""
    names = [k for k in ("mig", "halo", "k_max", "angular", "roll",
                         "sections") if k in codes]
    flags = torch.stack([codes[k] for k in names]).cpu().tolist()
    ovf = {k: True for k, f in zip(names, flags) if f}
    if ovf.get("roll"):
        ovf["roll_count"] = int(codes["roll_count"])
    if ovf.get("sections"):
        ovf["sec_deficit"] = codes["sec_deficit"].cpu().numpy()
    return ovf


def _neighbor_measure(pos, box, rq: float, k_probe: int, ghost_cap: int,
                      cell_cap: int):
    """A full neighbor matrix of radius rq over the whole system (cell
    list where the box holds one), grown until nothing truncates."""
    h = box.h.detach().cpu().numpy().astype(np.float64)
    shifts = nbops.image_shifts(1)
    for _ in range(16):
        ghosts = nbops.build_ghosts(pos, box, rq, ghost_cap, shifts)
        if int(ghosts.count) > ghost_cap:
            ghost_cap = ceil_to(int(ghosts.count) * 1.2, 8)
            continue
        grid = clmod.CellGrid.for_box(h, rq, cell_cap)
        if grid is not None:
            nl = clmod.build_neighbor_matrix_cells(pos, box, rq, k_probe,
                                                   ghosts, grid=grid)
        else:
            nl = nbops.build_neighbor_matrix_brute(pos, box, rq, k_probe,
                                                   ghosts)
        max_count = int(nl.max_count)
        if max_count <= k_probe:
            return nl
        # k_probe too small, or a clipped cell table (k_probe + 1)
        if max_count == k_probe + 1:
            cell_cap *= 2
        k_probe = ceil_to(max_count * 1.2 + 4, 8)
    raise RuntimeError("degree measure kept truncating")


def _measure_asn_degrees(spec, pos, species, box, rlist):
    """(per-species degrees within rlist, per-species angular degrees
    within Rca, [n, S] per-row angular degree matrix) from one neighbor
    measure over the whole system (the JAX package's
    `_measure_asn_degrees`)."""
    n = pos.shape[0]
    with torch.no_grad():
        nl = _neighbor_measure(pos, box, float(rlist), 96, max(2048, n), 32)
        sp_ext = nbops.extended_species(species, nl.ghosts)
        _, _, cnt, keep = degree_measure(spec, pos, box, nl, sp_ext,
                                         float(rlist))
        cnt = cnt.cpu().numpy()
    return np.asarray(keep), cnt.max(axis=0), cnt


def _measure_angular_caps(spec, pos, species, box, margin=1.3):
    """Per-species angular caps of the xla engine's blocked angular AEV
    (its own rounding: +margin and +2, rounded to 4) from one neighbor
    measure of radius Rca over the whole system."""
    n = pos.shape[0]
    with torch.no_grad():
        nl = _neighbor_measure(pos, box, float(spec.aev.angular_cutoff), 48,
                               max(1024, n // 4), 24)
        sp_ext = nbops.extended_species(species, nl.ghosts)
        degs = degree_measure(spec, pos, box, nl, sp_ext)[2].max(0).values
    return tuple(0 if d == 0 else ceil_to(int(d * margin + 2), 4)
                 for d in degs.tolist())
