"""The MD engine's host loop: one chunk = rebuild + up to N
velocity-Verlet steps.

Port of lammps_ani_tpu/md/simulation.py, with its engines under the JAX
package's names:

  * `mirror` (the default, `cellroll=False`): the AEV over a neighbor
    matrix of radius max(cutoff, Rcr) + skin (the JAX engine's is cutoff
    + skin) and a frozen angular sub-list of radius
    Rca + ang_skin, both resolved into owner/shift/mirror tables
    (ops/nbr_grad.py) whose backward gathers instead of scattering; plain
    PyTorch, no kernel; carries the XTB repulsion term.
  * `xla` and `pallas`, the cell-roll hybrids: the mirror engine with its
    radial channel from one coarse roll grid instead (side >= Rcr +
    ang_skin or Rcr + skin), by `cell_roll.radial_aev_cellroll` (plain
    PyTorch) or by the radial kernels of ops/aev_roll.py at shell 1; no
    repulsion term (a repulsion potential runs the plain mirror).
  * `pallas_asn`: both AEV channels and the XTB repulsion term from the
    assignment-compacted kernels (ops/aev_asn.py) over one coarse bin grid
    (side >= Rcr + skin); every `rebuild_every` steps the bins and the
    window-lane assignment (keep radius Rcr + skin) are rebuilt. The
    compact sections, the angular caps and the occupancy tiers are sized
    from one degree measure at `init_state`. `pair_stage` picks the
    angular pair stage (`aev_asn.PAIR_STAGES`): "packed" (the default)
    sizes up to three tiers by the chunk-budget ladder, the per-block
    stages ("blocks", "blocks_full") two tiers under their own work
    model, as the JAX engine does under LAT_ANG_PACKED=0.
  * `pallas_full`: both channels from the roll-grid kernels
    (ops/aev_roll.py) over one fine bin grid; no repulsion term.

`engine=None` resolves as the JAX package does: `cellroll=False` gives
the mirror engine; `cellroll=True` gives `pallas_asn` in f32 on the card
(the JAX package's "TPU and f32") and the `xla` hybrid elsewhere. An
explicit `engine` is the counterpart of the JAX package's LAT_ROLL_IMPL.
A box too small for the 3x3x3 grid of a roll engine runs the mirror
engine (`sim.engine` says which ran; an explicit `engine` that does not
run warns).

`sort_species` (default True): atoms held species-major, cell-minor, so
the MLP runs one static block per species; False keeps the caller's
species order (cell order only) and every engine takes the masked MLP
(each present species' net on every atom). `auto_angular_caps` (default
True): the angular caps come from the measured degrees at `init_state`
and grow at a regrow; False, or caps already in the spec, keeps the
spec's caps: the degree measure still sizes the engine's own capacities
(k_max, the sub-list cap, the asn sections and tiers), an angular
overflow raises "angular_caps overflow", and `pallas_full`/`pallas_asn`
without caps run the `pallas` hybrid, as in the JAX package.

Integrators (`integrator=`): None (NVE), `Langevin`, `NoseHoover` (the
CLI's nvt) and `NoseHooverNPT` (its npt); `barostat=` a
`BerendsenBarostat` with any of the first three. A step, in the JAX
package's order (md/integrate.py):

  NPT: piston half step, chain half step, MTK velocity scale
  NVT: chain half step
  v += dt/2 * ftm2v * f/m
  NPT: box and positions scale by exp(dt omega) about the box origin
  x += dt * v ;  f = forces(x, box) (+ Langevin)
  v += dt/2 * ftm2v * f/m
  NPT: MTK velocity scale, chain half step, piston half step at the new
       virial;  NVT: chain half step
  Berendsen: box and positions scale by the pressure's factor

The kernels take the state's box every step. Under a barostat the grids
are sized with 6% slack, and `run` re-derives them at the top of a chunk
when the box has left it (one `regrow_events`), as the JAX engine does.

Neighbor contract (LAMMPS `neigh_modify check yes`): if any atom moved
more than skin_eff/2 since the rebuild (skin_eff = skin on the asn and
roll engines, min(skin, ang_skin) on the mirror engine and its hybrids,
whose angular sub-list is frozen), the chunk stops before the next step
and `run` resumes from a fresh rebuild at exactly that state. Capacity
overflow (ghost images, the neighbor matrix's k_max, a slot without its
mirror or an angular sub-list over its cap, a roll bin over `cap`, a
compact section over its lanes, an angular cap truncating neighbors, the
last tier short of rows) is reported per chunk; `run` grows exactly that
capacity, never shrinking one, and re-runs the chunk from its input
state.

`constraints=` a `constraints.Rattle` (the pairs in the caller's atom
order, mapped to the engine's in `init_state`, after the spatial sort or a
restart's `order`): one dof less per constraint (velocities drawn at
`init_state`, the thermo row's temperature, the chains and the piston);
the positions are projected after the drift (the pre-drift positions as
the old ones), the velocities after the second half kick. `extra_force=`
a callable (pos, box, step) -> [n, 3] kcal/mol/A (md/bias.py's forces):
it sees the positions in the caller's order, its force is mapped back to
the engine's and added to the force only, not to the virial; `step` is
the state's step before the increment (0 at `init_state`).

The JAX package's environment overrides and what takes their place here
(the port reads no environment variable on its paths):

  LAT_ROLL_IMPL         `engine=` (ENGINES).
  LAT_ANG_PACKED        `pair_stage=` ("packed"; 0: "blocks").
  LAT_ANG_TRI           `pair_stage=` (0 with LAT_ANG_PACKED=0:
                        "blocks_full").
  LAT_ROLL_CAP_MARGIN   ROLL_CAP_MARGIN.
  LAT_SEC_MARGIN        SEC_MARGIN.
  LAT_ANG_CAP_MARGIN    ANG_CAP_MARGIN.
  LAT_ANG_TIERS         ANG_TIERS.
  LAT_ANG_TIER_MIN_N    ANG_TIER_MIN_ATOMS.
  LAT_TIER0_MARGIN      TIER_ROWS_MARGIN (with TIER_ROWS_EXTRA).
  LAT_TIER_ROWS_MARGIN  LAST_TIER_ROWS_MARGIN (with LAST_TIER_ROWS_EXTRA).
  LAT_EXP_RECUR         nothing: it switches the JAX radial shifts between
                        a recurrence and direct exps, which agree to
                        rounding; the CUDA kernels take one hardware exp2
                        per shift.
  LAT_MATMUL_PRECISION  nothing: TF32 is pinned off (lammps_ani_torch/
                        __init__.py), so f32 products keep full f32.
  LAT_NN_PRECISION      nothing: the MLP runs in the run's dtype, f32
                        products without TF32, as above.
  LAT_NN_REMAT          nothing: it recomputes the MLP in its backward
                        (by default from 150,000 rows) to save the TPU's
                        memory; the port's MLP keeps its activations, which
                        the card holds at every size the engines run.
  LAT_VERBOSE           nothing: `sim.engine`, `sim.sizing()` and
                        `regrow_kinds` say what ran and what grew.

Spans (utils/profiling.py; off unless a recording or a torch.profiler
runs): `chunk` around each pass of `run`'s loop (noted `discarded` with
what overflowed where a regrow re-runs it), holding `rebuild` (the wrap,
the bins and assignment, the overflow reads), per step `step` (its
`skin_check`, `integrate` before and after the forces, `forces`) and
`thermo`, the closing `skin_check`, `deficit_check` and `regrow`. Every
operation of the loop that makes the host wait goes through
`profiling.sync` (`to_host` for the read backs) under its site:
skin_check, roll_count, overflow, overflow_sections, deficits,
chunk_disp, thermo_readback, box_check here; bins (ops/cell_roll.py),
mlp_columns and self_energies (models/networks.py) below.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .. import units
from .._device import resolve_device
from ..models import aev as aevmod
from ..models import potential as potmod
from ..ops import aev_asn
from ..ops import aev_roll
from ..ops import cell_list as clmod
from ..ops import cell_roll as crmod
from ..ops import nbr_grad
from ..ops import neighbors as nbops
from ..utils.profiling import note, phase, to_host
from . import integrate
from .constraints import Rattle
from .sizing import (ANG_CAP_MARGIN, BAROSTAT_SLACK, SEC_MARGIN, angular_caps,
                     ceil_to, degree_measure)
from .state import MDState

INTEGRATORS = (integrate.Langevin, integrate.NoseHoover,
               integrate.NoseHooverNPT)

# Extra roll-bin slots above the measured occupancy (+2 base): the t=0
# occupancy sits one thermal fluctuation below the run's high-water mark.
ROLL_CAP_MARGIN = 4
# asn engine, occupancy tiers of the pair stage: at most this many tiers,
# none below this many atoms; row capacities of the tiers before the last
# (a spill only cascades) and of the last (the one that must hold).
ANG_TIERS = 3
ANG_TIER_MIN_ATOMS = 4096
TIER_ROWS_MARGIN, TIER_ROWS_EXTRA = 1.06, 64
LAST_TIER_ROWS_MARGIN, LAST_TIER_ROWS_EXTRA = 1.3, 4096

ENGINES = ("mirror", "xla", "pallas", "pallas_full", "pallas_asn")


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    cutoff: float  # interaction cutoff (Angstrom)
    skin: float = 2.0
    # skin of the frozen angular sub-list (mirror engine and hybrids): its
    # sphere is Rca + ang_skin; the engine holds disp < min(skin,
    # ang_skin)/2 between rebuilds
    ang_skin: float = 1.0
    k_max: int = 64  # degree-measure neighbor matrix width (auto-grown)
    ghost_capacity: int = 4096
    n_shell: int = 1
    rebuild_every: int = 10
    use_cell_list: bool = False
    cell_capacity: int = 16

    @property
    def rlist(self) -> float:
        return self.cutoff + self.skin


class Simulation:
    """Host-side orchestration of one engine on one device.

    `cellroll`: the JAX package's switch of the cell-roll engines; with
    `engine=None`, False gives the mirror engine and True `pallas_asn` in
    f32 on the card, the `xla` hybrid elsewhere. `engine`: one of ENGINES,
    whatever `cellroll` says; where it cannot run (a repulsion potential
    on a hybrid, a box too small for its grid) the mirror engine runs and
    a RuntimeWarning names both. `pair_stage` (asn engine): the angular pair
    stage, "packed" (None: the default), "blocks" or "blocks_full".
    `sort_species`, `auto_angular_caps`: the JAX package's options (see the
    module docstring). Runs on the card unless `device` says otherwise."""

    def __init__(self, potential: potmod.ANIPotential, species: np.ndarray,
                 masses: np.ndarray, nbr: NeighborConfig, dt: float = 0.5,
                 integrator=None, dtype=torch.float32,
                 barostat=None, constraints=None,
                 extra_force: Optional[Callable] = None, device=None,
                 engine: Optional[str] = None,
                 pair_stage: Optional[str] = None, cellroll: bool = False,
                 sort_species: bool = True, auto_angular_caps: bool = True):
        if barostat is not None and isinstance(integrator,
                                               integrate.NoseHooverNPT):
            raise ValueError("NoseHooverNPT already includes a barostat")
        if integrator is not None and not isinstance(integrator,
                                                     INTEGRATORS):
            raise TypeError(f"integrator {type(integrator).__name__}: "
                            "expected None (NVE), Langevin, NoseHoover or "
                            "NoseHooverNPT")
        if barostat is not None and not isinstance(
                barostat, integrate.BerendsenBarostat):
            raise TypeError(f"barostat {type(barostat).__name__}: expected "
                            "a BerendsenBarostat")
        if constraints is not None and not isinstance(constraints, Rattle):
            raise TypeError(f"constraints {type(constraints).__name__}: "
                            "expected a Rattle")
        if extra_force is not None and not callable(extra_force):
            raise TypeError("extra_force: expected a callable (pos, box, "
                            "step) -> [n, 3]")
        self.device = resolve_device(device)
        self._engine_asked = engine
        if engine is None:
            if not cellroll:
                engine = "mirror"
            elif self.device.type == "cuda" and dtype == torch.float32:
                engine = "pallas_asn"
            else:
                engine = "xla"
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: expected one of {ENGINES}")
        if engine == "pallas_full" and potential.spec.repulsion is not None:
            raise ValueError(
                "engine pallas_full has no pair-distance channel for the "
                "repulsion term; use pallas_asn")
        self.pair_stage = pair_stage or "packed"
        aev_asn._check_stage(self.pair_stage)
        if engine != "pallas_asn" and self.pair_stage != "packed":
            raise ValueError(f"pair_stage {pair_stage!r} needs the "
                             "pallas_asn engine")
        # the caps are the spec's (fixed) unless they are to be measured
        self._auto_angular_caps = (auto_angular_caps
                                   and potential.spec.angular_caps is None)
        if engine in ("pallas_full", "pallas_asn") and not (
                auto_angular_caps or potential.spec.angular_caps):
            # the roll and asn angular kernels need caps: the pallas hybrid
            # (radial kernels, the mirror's angular channel)
            self._warn_fallback("no angular caps and auto_angular_caps is "
                                "off", "pallas")
            engine = "pallas"
        # the requested engine (LAT_ROLL_IMPL's counterpart); a repulsion
        # potential on a hybrid runs the plain mirror, as does a box too
        # small for the engine's grid (`_setup_grids`)
        self._roll_impl = engine
        self._want_cellroll = engine != "mirror" and (
            potential.spec.repulsion is None or engine == "pallas_asn")
        self.engine = engine if self._want_cellroll else "mirror"
        if not self._want_cellroll:
            self._warn_fallback("a hybrid carries no repulsion term")
        n = len(species)
        self.nbr = nbr
        self.dt = float(dt)
        self.integrator = integrator
        self.barostat = barostat
        self.dtype = dtype
        self._species_in = np.asarray(species)
        self._masses_in = np.asarray(masses, np.float64)
        self._sort_species = sort_species
        self.order = (np.argsort(species, kind="stable") if sort_species
                      else np.arange(n))
        self._apply_order()
        # weights on the run's device and in its dtype (f32 weights cast to
        # f64 exactly, as JAX's type promotion computes them), in a module
        # of the engine's own: Module.to would move the caller's in place
        self.potential = potmod.ANIPotential(
            potential.spec, potential.params).to(device=self.device,
                                                 dtype=dtype)
        num_species = potential.spec.net.num_species
        # static per-species blocks of the sorted MLP; None: the masked MLP
        self.species_counts = tuple(
            int((self.species_np == s).sum()) for s in range(num_species)
        ) if sort_species else None
        self.constraints = constraints
        self._rattle = None  # engine-order constraints, set at init_state
        self.extra_force = extra_force
        self.dof = 3 * n - 3 - (0 if constraints is None
                                else constraints.n_constraints)
        self.n_atoms = n
        self._shifts = nbops.image_shifts(nbr.n_shell)
        self._grid = None  # CellGrid of the neighbor matrix
        self._k_max = nbr.k_max
        self._ang_cap = None  # angular sub-list capacity (mirror engines)
        self._roll_grid = None
        self._roll_shell = 2
        self._rlist_query = self._mirror_rlist
        self._sections = None  # asn: ((species, lanes), ...) compact layout
        self._tiers = None  # asn: ((caps_t, rows_t), ...) or None
        # cumulative capacity regrows (callers warm up until it stops):
        # chunks that were run again, and what was grown
        self.regrow_events = 0
        self.regrow_kinds = {"ghost": 0, "k_max": 0, "mirror": 0, "roll": 0,
                             "sections": 0, "angular_caps": 0,
                             "tier_rows": 0}

    def _warn_fallback(self, why: str, instead: str = "mirror"):
        """Warn when an engine the caller named runs as another."""
        if self._engine_asked not in (None, instead):
            warnings.warn(f"engine {self._engine_asked!r} cannot run ({why}); "
                          f"the {instead} engine runs instead", RuntimeWarning,
                          stacklevel=3)

    @property
    def _asn(self) -> bool:
        return self.engine == "pallas_asn"

    @property
    def _full(self) -> bool:
        return self.engine == "pallas_full"

    @property
    def _mirror_tables(self) -> bool:
        """The mirror engine or a hybrid: a neighbor matrix and its mirror
        tables at every rebuild."""
        return self.engine in ("mirror", "xla", "pallas")

    def _apply_order(self):
        self.inv_order = np.argsort(self.order)
        self.species_np = self._species_in[self.order]
        self.species = torch.as_tensor(self.species_np, dtype=torch.int64,
                                       device=self.device)
        self.masses = torch.as_tensor(self._masses_in[self.order],
                                      dtype=self.dtype, device=self.device)
        # extra_force's order maps: engine -> caller, and back
        self._order_t = torch.as_tensor(self.order, device=self.device)
        self._inv_order_t = torch.as_tensor(self.inv_order,
                                            device=self.device)

    # ---------- setup ----------

    def init_state(self, pos: np.ndarray, box, vel: np.ndarray | None = None,
                   temp: float | None = None, seed: int = 12345,
                   order: np.ndarray | None = None) -> MDState:
        """`box`: an ops.neighbors.Box. Velocities: given (caller order),
        drawn at `temp` from `seed`, or zero. `order`: the atom order to
        hold (a restart's `sim.order`); None: the spatial sort."""
        pos = np.asarray(pos, np.float64)
        box = box.to(device=self.device, dtype=self.dtype)
        if order is None:
            self._spatial_sort(pos, box)
        else:
            self.order = np.asarray(order, np.int64)
            self._apply_order()
        if self.constraints is not None:
            inv = self.inv_order
            self._rattle = dataclasses.replace(
                self.constraints, pairs=tuple(
                    (int(inv[i]), int(inv[j]))
                    for i, j in self.constraints.pairs))
        pos_t = torch.as_tensor(pos[self.order], dtype=self.dtype,
                                device=self.device)
        self._setup_grids(pos_t, box)
        if vel is not None:
            vel_t = torch.as_tensor(np.asarray(vel)[self.order],
                                    dtype=self.dtype, device=self.device)
        elif temp is not None:
            g = torch.Generator(device="cpu").manual_seed(seed)
            vel_t = integrate.create_velocities(
                g, self.masses.cpu(), temp, self.dof).to(self.device)
        else:
            vel_t = torch.zeros_like(pos_t)
        self._derive_angular_caps(pos_t, box)
        self._check_kernel_caps()
        pos_w = nbops.wrap_positions(pos_t, box)
        bins = self._bins(pos_w, box)
        nlist = nbrs = None
        struct = bins
        if self._mirror_tables:
            nlist = self._build_nlist(pos_w, box)
            nbrs = self._mirror(nlist, pos_w, box)
            struct = (nbrs, bins)
        pe, force, virial, _ = self._forces(pos_w, box, struct)
        ts = bs = None
        if isinstance(self.integrator, integrate.NoseHooverNPT):
            ts = self.integrator.thermostat.init(self.dtype, self.device)
            bs = self.integrator.init(self.dtype, self.device)
        elif isinstance(self.integrator, integrate.NoseHoover):
            ts = self.integrator.init(self.dtype, self.device)
        # the asn tables are stale after the next rebuild and large: the
        # state does not carry them
        return MDState(pos=pos_w, vel=vel_t, force=force, box=box, step=0,
                       pe=pe, virial=virial, pos_at_rebuild=pos_w,
                       bins=None if self._asn else bins, nlist=nlist,
                       nbrs=nbrs, thermostat=ts, barostat=bs)

    def _spatial_sort(self, pos: np.ndarray, box: nbops.Box):
        """Species-major / cell-minor atom order (the JAX package's
        lexsort, so both packages hold atoms in the same order); cell order
        alone (a stable sort) without `sort_species`."""
        h = box.h.detach().cpu().numpy().astype(np.float64)
        origin = box.origin.detach().cpu().numpy().astype(np.float64)
        r = pos - origin
        f2 = r[:, 2] / h[2, 2]
        f1 = (r[:, 1] - f2 * h[2, 1]) / h[1, 1]
        f0 = (r[:, 0] - f1 * h[1, 0] - f2 * h[2, 0]) / h[0, 0]
        frac = np.stack([f0, f1, f2], 1) % 1.0
        side = max(self.nbr.rlist, 1e-6)
        ncell = np.maximum((np.abs(np.diag(h)) / side).astype(np.int64), 1)
        cc = np.minimum((frac * ncell).astype(np.int64), ncell - 1)
        cell_id = (cc[:, 0] * ncell[1] + cc[:, 1]) * ncell[2] + cc[:, 2]
        self.order = (np.lexsort((cell_id, self._species_in))
                      if self._sort_species
                      else np.argsort(cell_id, kind="stable"))
        self._apply_order()

    def _barostat_active(self) -> bool:
        return self.barostat is not None or isinstance(
            self.integrator, integrate.NoseHooverNPT)

    @staticmethod
    def _perp_lengths(box_h) -> np.ndarray:
        h = np.asarray(box_h, np.float64)
        v = abs(np.dot(h[0], np.cross(h[1], h[2])))
        return np.array([v / np.linalg.norm(np.cross(h[1], h[2])),
                         v / np.linalg.norm(np.cross(h[2], h[0])),
                         v / np.linalg.norm(np.cross(h[0], h[1]))])

    @property
    def _skin_eff(self) -> float:
        """Twice the displacement bound between rebuilds: the asn and
        roll engines re-compact their angular neighbors from the bins
        every step (skin); the mirror engine and its hybrids also freeze
        the angular sub-list (min(skin, ang_skin))."""
        if self._roll_impl in ("pallas_full", "pallas_asn"):
            return self.nbr.skin
        return min(self.nbr.skin, self.nbr.ang_skin)

    @property
    def _mirror_rlist(self) -> float:
        """The neighbor matrix's radius on the mirror engine: the larger of
        the configured cutoff and the model's Rcr, plus the skin. A
        NeighborConfig cutoff below Rcr (5.1 for ANI-1xnr's 5.2, as the
        JAX CLI configures it) would otherwise miss pairs that come within
        Rcr before the next rebuild where skin <= ang_skin."""
        return (max(self.nbr.cutoff, self.potential.spec.cutoff)
                + self.nbr.skin)

    @property
    def _roll_side(self) -> float:
        """Least bin side. pallas_full: one fine grid for both channels
        (the angular kernels read the 27-bin window, side >= Rca + skin;
        the radial a shell-2 window, 2 side >= Rcr + skin). pallas_asn and
        the pallas hybrid: one coarse grid whose 27-bin window reaches
        Rcr + skin. The xla hybrid: Rcr + ang_skin, as the JAX package."""
        spec = self.potential.spec
        if self._roll_impl == "pallas_full":
            return max(spec.aev.angular_cutoff + self._skin_eff,
                       (spec.cutoff + self._skin_eff) / 2.0)
        if self._roll_impl in ("pallas", "pallas_asn"):
            return spec.cutoff + self._skin_eff
        return spec.cutoff + self.nbr.ang_skin

    def _setup_grids(self, pos, box):
        """The roll grid of a roll engine (None and the mirror engine when
        the box holds no 3x3x3 grid of its side) and the neighbor matrix's
        cell grid, from the box as it is: at init_state and, under a
        barostat, whenever `_grids_valid` finds the box has left them;
        with a barostat both are sized with BAROSTAT_SLACK."""
        box_h = box.h.detach().cpu().numpy().astype(np.float64)
        spec = self.potential.spec
        slack = BAROSTAT_SLACK if self._barostat_active() else 1.0
        self.engine = self._roll_impl if self._want_cellroll else "mirror"
        self._roll_grid = None
        self._rlist_query = self._mirror_rlist
        probe = (crmod.RollGrid.for_box(box_h, self._roll_side * slack, 64)
                 if self._want_cellroll else None)
        if probe is None:
            if self._want_cellroll:
                self._warn_fallback("the box holds no 3x3x3 grid of side "
                                    f"{self._roll_side:.3f} A")
            self.engine = "mirror"
        else:
            cnt = int(crmod.build_bins(probe, nbops.wrap_positions(pos, box),
                                       self.species, box).count_max)
            cap = ceil_to(cnt + 2 + ROLL_CAP_MARGIN, 4)
            self._roll_grid = crmod.RollGrid(ncells=probe.ncells, cap=cap)
        if self._roll_grid is not None and not self._asn:
            # the angular sub-list (hybrids) or the fine grid's angular
            # window (pallas_full) is all the neighbor matrix must reach
            self._rlist_query = spec.aev.angular_cutoff + self.nbr.ang_skin
            if self.engine == "pallas":
                self._roll_shell = 1  # the coarse grid reaches the cutoff
            elif self._full:
                perp = self._perp_lengths(box_h)
                side_now = float((perp / np.asarray(probe.ncells)).min())
                # radial window: shell 1 if one bin reaches Rcr + skin
                self._roll_shell = (1 if side_now >= spec.cutoff
                                    + self._skin_eff else 2)
                self._rlist_query = (spec.aev.angular_cutoff
                                     + self._skin_eff)
        if self.nbr.use_cell_list:
            self._grid = clmod.CellGrid.for_box(
                box_h, self._rlist_query * slack, self.nbr.cell_capacity)
            # None: the box is too small for a 3x3x3 cell grid; brute build
            self._probe_cell_capacity(pos, box)

    def _grids_valid(self, box_h) -> bool:
        """Whether the grids still serve the (barostat-rescaled) box: every
        roll bin at least the engine's side (pallas_full's shell-1 radial
        window still reaching Rcr + skin), a roll grid where the box now
        holds one, the cell grid's ghost margin and cells still covering
        the query radius (the JAX engine's test)."""
        h = np.asarray(box_h, np.float64)
        perp = self._perp_lengths(h)
        if self._want_cellroll and self._roll_impl == "pallas_asn":
            if self._roll_grid is None:
                return crmod.RollGrid.for_box(h, self._roll_side, 4) is None
            return not np.any(perp / np.asarray(self._roll_grid.ncells)
                              < self._roll_side)
        if self._want_cellroll:
            if self._roll_grid is None:
                if crmod.RollGrid.for_box(h, self._roll_side, 4) is not None:
                    return False
            else:
                side_now = perp / np.asarray(self._roll_grid.ncells)
                if np.any(side_now < self._roll_side):
                    return False
                if (self._full and self._roll_shell == 1 and np.any(
                        side_now < self.potential.spec.cutoff
                        + self._skin_eff)):
                    return False
        if self.nbr.use_cell_list:
            rq = self._rlist_query
            if self._grid is None:
                if clmod.CellGrid.for_box(h, rq, 4) is not None:
                    return False
            else:
                m = np.asarray(self._grid.margin_frac)
                if np.any(rq / perp > m * (1 + 1e-12)):
                    return False
                side = perp * (1.0 + 2.0 * m) / np.asarray(self._grid.ncells)
                if np.any(side < rq):
                    return False
        return True

    def _probe_cell_capacity(self, pos, box) -> bool:
        """Grow the degree measure's cell capacity to the measured
        occupancy (a clipped cell table would truncate the measure)."""
        if self._grid is None or not self.nbr.use_cell_list:
            return False
        grid = self._grid
        pw = nbops.wrap_positions(pos, box)
        ghosts = nbops.build_ghosts(pw, box, self._rlist_query,
                                    self.nbr.ghost_capacity, self._shifts)
        pos_ext = nbops.extended_positions(pw, box, ghosts)
        valid = torch.cat([torch.ones((pos.shape[0],), dtype=torch.bool,
                                      device=pos.device), ghosts.mask])
        ids = clmod._flat_cell(grid, clmod._cell_coords(
            grid, box.to_fractional(pos_ext)))
        _, max_cell = clmod.build_cell_table(grid, ids, valid)
        cap = ceil_to(int(max_cell) * 1.15 + 2, 4)
        if cap > grid.cell_capacity:
            self._grid = dataclasses.replace(grid, cell_capacity=cap)
            return True
        return False

    def _build_nlist(self, pos, box):
        rq = self._rlist_query
        ghosts = nbops.build_ghosts(pos, box, rq, self.nbr.ghost_capacity,
                                    self._shifts)
        if self.nbr.use_cell_list and self._grid is not None:
            return clmod.build_neighbor_matrix_cells(
                pos, box, rq, self._k_max, ghosts, grid=self._grid)
        return nbops.build_neighbor_matrix_brute(pos, box, rq, self._k_max,
                                                 ghosts)

    def _derive_angular_caps(self, pos, box, regrow=False,
                             regrow_mirror=False):
        """Per-species angular caps from the measured per-species degrees
        within Rca (+10% and +2, +4 more for small degrees, rounded to 4;
        0 for species absent as neighbors), the neighbor matrix's k_max
        and the angular sub-list's cap (degrees within Rca + ang_skin,
        +10% and +2, rounded to 4) from one measure. `regrow` never
        shrinks a capacity and grows each cap by at least 4;
        `regrow_mirror` (a slot without its mirror, or the sub-list over
        its cap) grows the sub-list's cap by at least 4 and k_max by at
        least 8. The asn engine sizes its compact sections (degrees within
        the keep radius Rcr + skin) and its occupancy tiers (the per-atom
        degree matrix within Rca) from the same measure. Fixed caps (no
        `auto_angular_caps`) stay the spec's: only the engine's capacities
        are measured."""
        spec = self.potential.spec

        def measure():
            pos_w = nbops.wrap_positions(pos, box)
            nlist = self._build_nlist(pos_w, box)
            species_ext = nbops.extended_species(self.species, nlist.ghosts)
            dist, mask, cnt, sec = degree_measure(
                spec, pos_w, box, nlist, species_ext,
                spec.cutoff + self.nbr.skin if self._asn else None)
            in_ang_skin = mask & (dist < spec.aev.angular_cutoff
                                  + self.nbr.ang_skin)
            return ((cnt.max(0).values.tolist(), cnt, sec,
                     int(in_ang_skin.sum(dim=1).max())),
                    int(nlist.max_count))

        (degrees, cnt, sec_degrees, ang_deg), max_deg = measure()
        for _ in range(16):
            if max_deg <= self._k_max:
                break
            # the measuring matrix truncated (k_max too small, or a clipped
            # cell table reporting k_max + 1): regrow and re-measure
            self._probe_cell_capacity(pos, box)
            self._k_max = ceil_to(max_deg * 1.1 + 4, 8)
            (degrees, cnt, sec_degrees, ang_deg), max_deg = measure()
        else:
            raise RuntimeError(f"degree measure kept truncating (max_count "
                               f"{max_deg} > k_max {self._k_max})")
        old_ang_cap, old_k_max = self._ang_cap, self._k_max
        self._ang_cap = ceil_to(ang_deg * 1.1 + 2, 4)
        self._k_max = ceil_to(max_deg * 1.1 + 4, 8)
        if regrow or regrow_mirror:
            # a regrow runs at the chunk's input state, earlier than the
            # rebuild that overflowed: never shrink
            if old_ang_cap is not None:
                self._ang_cap = max(self._ang_cap, old_ang_cap)
            self._k_max = max(self._k_max, old_k_max)
        if regrow_mirror:
            # the same margins would re-derive what just failed: grow
            if old_ang_cap is not None:
                self._ang_cap = max(self._ang_cap, old_ang_cap + 4)
            self._k_max = max(self._k_max, ceil_to(old_k_max + 8, 8))
        if self._auto_angular_caps:
            caps = angular_caps(degrees, ANG_CAP_MARGIN)
            old = spec.angular_caps
            if regrow and old is not None:
                caps = tuple(0 if c == 0 else max(c, o + 4)
                             for c, o in zip(caps, old))
            self.potential = self.potential.with_spec(
                dataclasses.replace(spec, angular_caps=caps))
        else:
            caps = spec.angular_caps
        if self._asn:
            self._sections = aev_asn.sections_from_degrees(sec_degrees,
                                                           SEC_MARGIN)
            self._tiers = self._derive_tiers(cnt.cpu().numpy(), caps)

    def sizing(self) -> dict:
        """What the engine derived and grew, JSON-able: the engine that
        runs, its grids and every capacity. A restart carries it
        (io/restart.py), so the resumed run takes the shapes, and so the
        sums, of the run it continues."""
        spec = self.potential.spec
        rg, cg = self._roll_grid, self._grid
        return {
            "engine": self.engine, "k_max": self._k_max,
            "ang_cap": self._ang_cap,
            "angular_caps": (None if spec.angular_caps is None
                             else list(spec.angular_caps)),
            "roll_grid": None if rg is None else [list(rg.ncells), rg.cap],
            "roll_shell": self._roll_shell, "rlist_query": self._rlist_query,
            "cell_grid": None if cg is None else [
                list(cg.ncells), list(cg.margin_frac), cg.cell_capacity],
            "ghost_capacity": self.nbr.ghost_capacity,
            "sections": (None if self._sections is None
                         else [list(x) for x in self._sections]),
            "tiers": (None if self._tiers is None
                      else [[list(c), r] for c, r in self._tiers])}

    def restore_sizing(self, d: dict):
        """Take the sizing `d` that `sizing()` gave (a restart's)."""
        self.engine = d["engine"]
        self._k_max, self._ang_cap = d["k_max"], d["ang_cap"]
        caps = d["angular_caps"]
        self.potential = self.potential.with_spec(dataclasses.replace(
            self.potential.spec,
            angular_caps=None if caps is None else tuple(caps)))
        rg, cg = d["roll_grid"], d["cell_grid"]
        self._roll_grid = (None if rg is None else crmod.RollGrid(
            ncells=tuple(rg[0]), cap=rg[1]))
        self._roll_shell, self._rlist_query = d["roll_shell"], d["rlist_query"]
        self._grid = (None if cg is None else clmod.CellGrid(
            ncells=tuple(cg[0]), margin_frac=tuple(cg[1]),
            cell_capacity=cg[2]))
        self.nbr = dataclasses.replace(self.nbr,
                                       ghost_capacity=d["ghost_capacity"])
        self._sections = (None if d["sections"] is None
                          else tuple(tuple(x) for x in d["sections"]))
        self._tiers = (None if d["tiers"] is None
                       else tuple((tuple(c), r) for c, r in d["tiers"]))
        self._check_kernel_caps()

    def _check_kernel_caps(self):
        """pallas_full: a grid cap above what its angular kernels take at
        the angular caps (256, less only at caps whose per-warp slots do
        not fit a block) raises ValueError here, at init_state, a regrow or
        a re-derive, not mid-chunk (`aev_roll.check_cap`: on the card the
        kernels' own limit, on the CPU its transcription)."""
        if not self._full:
            return
        spec = self.potential.spec
        caps, _ = aev_roll.effective_caps(spec.aev, spec.angular_caps,
                                          self.species_counts)
        for name in ("angular_fwd", "angular_bwd"):
            aev_roll.check_cap(name, self._roll_grid.cap, caps, self.dtype,
                               self.device)

    def _derive_tiers(self, cnt, caps):
        """Occupancy tiers of the asn pair stage from the measured degree
        matrix `cnt` [n, S]: rows whose per-species degrees fit narrower
        caps run fewer pair lanes; the last tier runs the full caps. Only
        the last tier's row capacity must hold (a spill cascades from tier
        to tier and the last one's is reported in the deficit), so it gets
        the generous margin. The packed stage takes the chunk-budget ladder
        (up to ANG_TIERS tiers); the per-block stages, and the packed one
        where no ladder pays, take two tiers from `search_tiers` under the
        stage's work model. None: one tier is as good, or too few atoms."""
        n = self.n_atoms
        if ANG_TIERS < 2 or n < ANG_TIER_MIN_ATOMS:
            return None

        def rows(count):
            return min(int(count * TIER_ROWS_MARGIN) + TIER_ROWS_EXTRA, n)

        ladder = (aev_asn.search_tier_ladder(cnt, caps, max_pre=ANG_TIERS - 1)
                  if ANG_TIERS > 2 and self.pair_stage == "packed" else None)
        if ladder is not None:
            tiers = [(tuple(caps_t), rows(n_t)) for caps_t, n_t in ladder]
            rest = n - sum(n_t for _, n_t in ladder)
            tiers.append((tuple(caps), min(
                int(rest * LAST_TIER_ROWS_MARGIN) + LAST_TIER_ROWS_EXTRA, n)))
            return tuple(tiers)
        res = aev_asn.search_tiers(cnt, caps, self.pair_stage)
        if res is None:
            return None
        caps0, n0 = res
        return ((tuple(caps0), rows(n0)),
                (tuple(caps), min(int((n - n0) * LAST_TIER_ROWS_MARGIN) + 256,
                                  n)))

    @property
    def kpad(self) -> int:
        """asn: compact lanes per center (the sections and one dead lane,
        rounded up to 128)."""
        return aev_asn._round_lane(sum(k for _, k in self._sections) + 1)

    def _bins(self, pos, box):
        """The rebuild's roll bins (None without a roll grid), and for the
        asn engine (bins, assignment) over the keep radius Rcr + skin (it
        covers Rca + skin, and the step re-compacts the lanes within Rca
        anyway)."""
        if self._roll_grid is None:
            return None
        bins = crmod.build_bins(self._roll_grid, pos, self.species, box)
        if not self._asn:
            return bins
        return bins, aev_asn.build_assignment(
            self._roll_grid, bins, pos, box, self._sections, self.kpad,
            self.potential.spec.cutoff + self.nbr.skin)

    def _mirror(self, nlist, pos, box):
        """MirrorNeighbors with the angular sub-list (radius Rca +
        ang_skin). The full list's mirror table is skipped when the roll
        grid serves the radial channel (the hybrids)."""
        return nbr_grad.mirror_neighbors(
            nlist, self.n_atoms, pos=pos, box=box,
            ang_cutoff=self.potential.spec.aev.angular_cutoff
            + self.nbr.ang_skin, ang_cap=self._ang_cap, species=self.species,
            main_mirror=self._roll_grid is None)

    def _angular_overflow(self, pos, box, nlist) -> bool:
        """Any per-species angular degree over the static caps (none
        without caps: the generic angular channel)."""
        spec = self.potential.spec
        if spec.angular_caps is None:
            return False
        species_ext = nbops.extended_species(self.species, nlist.ghosts)
        _, dist = nbops.neighbor_displacements(pos, box, nlist)
        species_j = species_ext[nlist.idx]
        mask = nlist.mask & (species_j >= 0)
        return bool(to_host(aevmod.angular_cap_deficit(
            spec.aev, dist, species_j, mask, spec.angular_caps) > 0,
            "overflow"))

    # ---------- per step ----------

    def _forces(self, pos, box, bins, step: int = 0):
        """(pe, force, virial, angular deficit) in kcal/mol units at the
        rebuild's structure `bins`: (MirrorNeighbors, roll bins or None)
        for the mirror engine and its hybrids (no deficit: their caps are
        checked at the rebuild), the roll bins (pallas_full; one deficit)
        or (bins, assignment) (pallas_asn; one deficit per species and,
        when tiered, the rows the last tier could not hold). `extra_force`
        at `step` adds to the force, not to the virial."""
        if self._mirror_tables:
            nbrs, rbins = bins
            cellroll = (None if rbins is None
                        else (self._roll_grid, rbins, self.engine))
            pe, f, w = potmod.energy_forces_virial_mirror(
                self.potential, self.species, pos, box, nbrs,
                self.species_counts, cellroll=cellroll)
            deficit = torch.zeros((), dtype=pos.dtype, device=pos.device)
        elif self._asn:
            rbins, rasn = bins
            pe, f, w, deficit = potmod.energy_forces_virial_asn(
                self.potential, self.species, pos, box,
                (self._roll_grid, rbins, rasn, self._sections, self._tiers,
                 self.pair_stage), self.species_counts)
        else:
            pe, f, w, deficit = potmod.energy_forces_virial_roll(
                self.potential, self.species, pos, box, self._roll_grid,
                bins, self.species_counts, radial_shell=self._roll_shell)
        c = units.HARTREE2KCALMOL
        f = f * c
        if self.extra_force is not None:
            f_in = self.extra_force(pos[self._inv_order_t], box, step)
            f = f + f_in.to(f.dtype)[self._order_t]
        return pe * c, f, w * c, deficit

    def _pressure(self, vel, virial, box):
        """[] scalar pressure in atm."""
        return torch.trace(integrate.pressure_tensor(
            vel, self.masses, virial, box.volume)) / 3.0

    def _step(self, st: MDState):
        """One step in the JAX engine's order (module docstring)."""
        dt, masses, dof = self.dt, self.masses, self.dof
        vel, pos, box = st.vel, st.pos, st.box
        ts, bs = st.thermostat, st.barostat
        npt = (self.integrator if isinstance(self.integrator,
                                             integrate.NoseHooverNPT)
               else None)
        nvt = (self.integrator if isinstance(self.integrator,
                                             integrate.NoseHoover) else None)
        n = self.n_atoms
        with phase("integrate"):
            if npt is not None:
                ke = integrate.kinetic_energy(vel, masses)
                bs = npt.piston_half(bs, self._pressure(vel, st.virial, box),
                                     box.volume, ke, n, dt, dof)
                ts, vel = npt.thermostat.half_step(ts, vel, masses, dof, dt)
                vel = vel * npt.vel_scale(bs.omega, dof, n, dt)
            elif nvt is not None:
                ts, vel = nvt.half_step(ts, vel, masses, dof, dt)
            vel = integrate.nve_halfkick(vel, st.force, masses, dt)
            if npt is not None:
                s = npt.box_scale(bs.omega, dt)
                box = integrate.rescale_box(box, s)
                pos = box.origin + (pos - box.origin) * s
            pos_old = pos
            pos = integrate.nve_drift(pos, vel, dt)
            if self._rattle is not None:
                pos, vel = self._rattle.project_positions(pos, pos_old, vel,
                                                          masses, box, dt)
        with phase("forces"):
            pe, force, virial, deficit = self._forces(
                pos, box, (st.nbrs, st.bins) if self._mirror_tables
                else st.bins, st.step)
        with phase("integrate"):
            if isinstance(self.integrator, integrate.Langevin):
                force = force + self.integrator.force(vel, masses, dt)
            vel = integrate.nve_halfkick(vel, force, masses, dt)
            if self._rattle is not None:
                vel = self._rattle.project_velocities(pos, vel, masses, box)
            if npt is not None:
                vel = vel * npt.vel_scale(bs.omega, dof, n, dt)
                ts, vel = npt.thermostat.half_step(ts, vel, masses, dof, dt)
                ke = integrate.kinetic_energy(vel, masses)
                bs = npt.piston_half(bs, self._pressure(vel, virial, box),
                                     box.volume, ke, n, dt, dof)
            elif nvt is not None:
                ts, vel = nvt.half_step(ts, vel, masses, dof, dt)
            if self.barostat is not None:
                s = self.barostat.scale_factor(
                    self._pressure(vel, virial, box), dt)
                box = integrate.rescale_box(box, s)
                pos = box.origin + (pos - box.origin) * s
        return st.replace(pos=pos, vel=vel, force=force, pe=pe,
                          virial=virial, box=box, step=st.step + 1,
                          thermostat=ts, barostat=bs), deficit

    def _thermo(self, st: MDState) -> torch.Tensor:
        """[6] pe, ke, temp, press, vol, density (device scalars)."""
        ke = integrate.kinetic_energy(st.vel, self.masses)
        vol = st.box.volume
        press = self._pressure(st.vel, st.virial, st.box)
        return torch.stack([
            st.pe, ke, 2.0 * ke / (self.dof * units.BOLTZ), press, vol,
            torch.sum(self.masses) / units.AVOGADRO_VOL / vol])

    _THERMO_KEYS = ("pe", "ke", "temp", "press", "vol", "density")

    def _chunk(self, state: MDState, n_take: int):
        """One rebuild + up to n_take steps; stops early (before stepping)
        once any atom moved more than skin/2 since the rebuild.

        Returns (state, thermo [k, 6], max displacement, overflow, steps
        done). `overflow` names what this chunk's rebuild or steps
        outgrew, with the size `run` grows it by: "ghost" (periodic images
        over the ghost capacity), "k_max" (a row of the neighbor matrix
        over it), "mirror" (a slot without its mirror, or the angular
        sub-list over its cap), "roll" (a bin's occupancy), "sections"
        (per-species lanes over the section), "angular" (per-species
        neighbors over the cap) and "tier_rows" (rows the last tier could
        not hold); empty when nothing did."""
        box = state.box
        with phase("rebuild"):
            pos_w = nbops.wrap_positions(state.pos, box)
            bins = self._bins(pos_w, box)
            rbins, rasn = bins if self._asn else (bins, None)
            overflow = {}
            if rbins is not None:
                roll_count = int(to_host(rbins.count_max, "roll_count"))
                if roll_count > self._roll_grid.cap:
                    overflow["roll"] = roll_count
            if rasn is not None and float(to_host(rasn.ovf, "overflow")) > 0:
                overflow["sections"] = to_host(rasn.ovf_sec,
                                               "overflow_sections").numpy()
            nlist = nbrs = None
            if self._mirror_tables:
                nlist = self._build_nlist(pos_w, box)
                nbrs = self._mirror(nlist, pos_w, box)
                if int(to_host(nlist.ghosts.count, "overflow")) > \
                        nlist.ghosts.src.shape[0]:
                    overflow["ghost"] = True
                if int(to_host(nlist.max_count, "overflow")) > \
                        nlist.idx.shape[1]:
                    overflow["k_max"] = True
                if not bool(to_host(nbrs.ok, "overflow")):
                    overflow["mirror"] = True
                # the mirror engine's caps are checked at the rebuild
                if self._angular_overflow(pos_w, box, nlist):
                    overflow["angular"] = True
        st = state.replace(pos=pos_w, bins=bins, pos_at_rebuild=pos_w,
                           nlist=nlist, nbrs=nbrs)
        if overflow:
            # atoms fell out of a capacity: no step would be right
            return st.replace(bins=None), None, 0.0, overflow, 0
        half_skin = self._skin_eff / 2.0
        rows, deficits = [], []
        n_done = 0
        disp = 0.0
        for _ in range(n_take):
            with phase("step"):
                with phase("skin_check"):
                    disp = float(to_host(torch.linalg.norm(
                        st.pos - pos_w, dim=-1).max(), "skin_check"))
                if disp > half_skin:
                    break
                st, deficit = self._step(st)
            deficits.append(deficit)
            with phase("thermo"):
                rows.append(self._thermo(st))
            n_done += 1
        if deficits:
            # the worst deficit over the chunk's steps, per entry
            with phase("deficit_check"):
                worst = to_host(torch.stack(deficits).max(0).values,
                                "deficits").numpy()
            n_sp = self.potential.spec.aev.num_species
            if self._full:
                if worst > 0:
                    overflow["angular"] = float(worst)
            elif self._asn:
                if worst[:n_sp].max() > 0:
                    overflow["angular"] = worst[:n_sp]
                if len(worst) > n_sp and worst[n_sp] > 0:
                    overflow["tier_rows"] = int(worst[n_sp])
        with phase("skin_check"):
            disp = float(to_host(torch.linalg.norm(
                st.pos - pos_w, dim=-1).max(), "chunk_disp"))
        with phase("thermo"):
            thermo = torch.stack(rows) if rows else None
        if self._asn:
            st = st.replace(bins=None)
        return st, thermo, disp, overflow, n_done

    def _regrow(self, state: MDState, overflow: dict):
        """Grow exactly the capacities that `overflow` names, each by what
        was measured (never less than one rounding step, never down).
        Fixed angular caps do not grow: their overflow raises."""
        if "angular" in overflow and not self._auto_angular_caps:
            raise RuntimeError(
                "angular_caps overflow: raise ANISpec.angular_caps or enable "
                f"auto_angular_caps (caps {self.potential.spec.angular_caps}, "
                f"deficit {overflow['angular']})")
        if "ghost" in overflow:
            self.nbr = dataclasses.replace(
                self.nbr, ghost_capacity=int(self.nbr.ghost_capacity * 1.5))
            self.regrow_kinds["ghost"] += 1
        if "roll" in overflow:
            # to the measured occupancy (+2, rounded to 4): every extra
            # slot adds 27 window lanes to every kernel of the step
            old = self._roll_grid.cap
            new_cap = max(ceil_to(overflow["roll"] + 2, 4), old + 4)
            self._roll_grid = crmod.RollGrid(ncells=self._roll_grid.ncells,
                                             cap=new_cap)
            self.regrow_kinds["roll"] += 1
        if "sections" in overflow:
            # exactly the overflowing sections, by their reported deficits
            # (a re-measure at the chunk's input state could give back the
            # sections that just overflowed)
            dv = overflow["sections"]
            self._sections = tuple(
                (s, k + max(4, ceil_to(dv[s], 4))
                 if s < len(dv) and dv[s] > 0 else k)
                for s, k in self._sections)
            self.regrow_kinds["sections"] += 1
        if not self._asn and any(k in overflow for k in ("k_max", "mirror",
                                                         "angular")):
            # re-measure the degrees at the chunk's input state: k_max,
            # the sub-list's cap and the angular caps, each never down
            if "k_max" in overflow:
                # a clipped cell table also reports as k_max overflow
                self._probe_cell_capacity(state.pos, state.box)
                self.regrow_kinds["k_max"] += 1
            self.regrow_kinds["mirror"] += "mirror" in overflow
            self.regrow_kinds["angular_caps"] += "angular" in overflow
            self._derive_angular_caps(state.pos, state.box,
                                      regrow="angular" in overflow,
                                      regrow_mirror="mirror" in overflow)
        elif "angular" in overflow or "tier_rows" in overflow:
            spec = self.potential.spec
            caps = spec.angular_caps
            if "angular" in overflow:
                # exactly the overflowing caps, by the kernels' per-species
                # deficits: no degree re-measure
                caps = tuple(
                    c if (c == 0 or d <= 0) else c + max(4, ceil_to(d, 4))
                    for c, d in zip(caps, overflow["angular"]))
                self.potential = self.potential.with_spec(
                    dataclasses.replace(spec, angular_caps=caps))
                self.regrow_kinds["angular_caps"] += 1
            if self._tiers is not None:
                last_rows = self._tiers[-1][1]
                if "tier_rows" in overflow:
                    last_rows += max(256, int(overflow["tier_rows"] * 1.5))
                    self.regrow_kinds["tier_rows"] += 1
                self._tiers = self._tiers[:-1] + ((caps, last_rows),)
        self._check_kernel_caps()

    def _rederive_grids(self, state: MDState):
        """The grids from the state's box (`_setup_grids`: the roll grid,
        its cap from the measured occupancy, pallas_full's radial shell,
        the engine where no roll grid fits any more, the cell grid), then
        what the port sizes from them: the angular kernels' cap check
        (pallas_full). The asn sections and tiers, the angular caps, k_max
        and the sub-list's cap come from the degree measure, not the grid,
        and stay; a chunk that outgrows one still regrows it. (An asn
        engine that ran as the mirror until the box grew a grid has no
        sections yet: it measures them.)"""
        self._setup_grids(state.pos, state.box)
        if self._asn and self._sections is None:
            self._derive_angular_caps(state.pos, state.box)
        self._check_kernel_caps()

    # ---------- host API ----------

    def run(self, state: MDState, n_steps: int,
            thermo_every: int | None = None,
            thermo_callback: Optional[Callable] = None):
        """Advance n_steps. Returns (state, thermo_rows); rows carry
        step pe ke etotal temp press vol density."""
        rows = []
        chunk = self.nbr.rebuild_every
        done = 0
        recap_attempts = 0
        while done < n_steps:
            with phase("chunk"):
                if self._barostat_active() and not self._grids_valid(
                        to_host(state.box.h, "box_check").numpy()):
                    # the box left the grids' slack: re-derive them
                    self._rederive_grids(state)
                    self.regrow_events += 1
                take = min(chunk, n_steps - done)
                new_state, thermo, disp, overflow, n_done = self._chunk(
                    state, take)
                if overflow:
                    # grow exactly what overflowed; re-run the chunk from its
                    # (untouched) input state
                    recap_attempts += 1
                    self.regrow_events += 1
                    if recap_attempts > 8:
                        raise RuntimeError(
                            "capacities keep overflowing after 8 regrows: "
                            f"{overflow}")
                    note(discarded=sorted(overflow))
                    with phase("regrow"):
                        self._regrow(state, overflow)
                    continue
                # the limit is on consecutive regrows without progress
                recap_attempts = 0
                if n_done == 0:
                    raise RuntimeError(
                        f"atoms moved {disp:.3f} A > skin/2 "
                        f"({self.nbr.skin / 2:.2f}) in ONE step: raise skin "
                        "or lower dt")
                state = new_state
                if thermo_every:
                    with phase("thermo"):
                        th = to_host(thermo, "thermo_readback").numpy()
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

    def positions_input_order(self, state: MDState) -> np.ndarray:
        """Positions permuted back to the caller's atom order."""
        return state.pos.detach().cpu().numpy()[self.inv_order]

    def forces_input_order(self, state: MDState) -> np.ndarray:
        return state.force.detach().cpu().numpy()[self.inv_order]

    def velocities_input_order(self, state: MDState) -> np.ndarray:
        return state.vel.detach().cpu().numpy()[self.inv_order]
