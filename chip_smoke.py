"""Drive the PyTorch/CUDA port (lammps_ani_torch) on one CUDA card.

Run from the root of the repository, on a machine with one card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It imports neither JAX nor lammps_ani_tpu. Phases, each printing one JSON
object per line; any failure raises and the script exits non-zero:

  device   the card as torch and nvidia-smi report it.
  build    nvcc builds lammps_ani_torch/csrc/aev_roll.cu, aev_asn.cu and
           probes.cu for sm_90a, all at once; ptxas's registers per kernel.
  kernels  each of the four roll kernels against its plain PyTorch version
           on the card, WATER30 x 6^3 (6,480 atoms), in f64 and f32; two
           calls of each bit for bit (f64 and f32); radial_fwd launched
           into an output filled with NaN first, at shell 2 and shell 1
           and on the grid padded to cap 256 at shell 2 (an entry it does
           not write fails the comparison);
           angular_fwd at caps below the measured degree (output and
           deficit against the plain version's); radial_bwd, angular_fwd
           and angular_bwd on the grid padded to cap 256, the most each
           host takes (the angular hosts' limit and the offsets they stage
           a pass there equal to their transcriptions'; angular_fwd, whose
           whole window fits there, also in its pass form), the padding
           exactly 0, the angular pass forms at the grid's own cap equal
           to the whole-window kernels bit for bit, and cap 257 raising the
           named ValueError before any launch; the SASS lines and local
           loads and stores (LDL/STL) of the angular kernels' f32 forms;
           radial_bwd's dh exactly
           0 from cotangents on the rows of the bins whose shell-2 window
           is unshifted; radial_fwd and radial_bwd at shell 1 (the pallas
           hybrid's window); the kernels' backwards against autograd
           through the plain forwards (f64).
  potential  E, F, W of the roll engine on the card against the plain path
           on the CPU, WATER30 x 4^3 (1,920 atoms), f64.
  asn_kernels  the twelve asn kernels (csrc/aev_asn.cu: assignment build
           inv and idx, fused step forward, packed angular pairs, the
           backward's radial_gamma, packed_bwd, chain_sum and wing, and the
           per-channel radial_fwd_asn, compact_asn, radial_bwd_asn and
           decompact_chain, the radial ones in both column layouts) against
           their plain versions on the card at WATER30 x 6^3 with ANI-2x +
           XTB repulsion, sized by `Simulation`, in f64 and f32: integer
           outputs exactly, floats within the limits below; the packed
           kernels also on rows with every slot parked (exact zeros) and
           with one live slot per section, and their worst error as a
           fraction of its limit; build_inv equal to its plain version
           on the grid's rows with no atom (1,296), every entry there
           kpad - 1; radial_gamma and chain_sum exactly 0 on
           the rows with no atom and on the dead lanes, and the dh of
           chain_sum, decompact_chain and radial_bwd_asn exactly 0 from
           cotangents on interior bins' rows only; the whole
           backward (dpos, dh) of `aev_asn_fused`, `radial_aev_asn` and
           `angular_aev_asn` against autograd through the plain forwards
           (f64), two calls of each bit for bit (f64 and f32); the
           per-channel forwards equal to the fused forward bit for bit;
           the summed per-channel gradients against the fused gradient;
           `n_out` below the atom count on the card against the CPU (f64);
           E, F, W of `energy_forces_virial_asn` on the card against the
           CPU (f64); with repulsion off, F and W against the roll
           engine's (f64).
  asn_blocks  the per-block pair stage (pair_stage "blocks" and
           "blocks_full") at WATER30 x 6^3, sized by
           `Simulation(pair_stage="blocks")`, f64 and f32: its four
           kernels (block_fwd, block_fwd_tri, block_bwd, block_bwd_tri)
           against their plain versions at the full caps, at tier caps
           and on rows with every third row parked whole (arm rows with
           every slot parked and partly parked counted, both required),
           in both same-species forms, two calls of each kernel bit for
           bit, the forwards' rows parked whole exact zeros (counted,
           required); the backwards of `aev_asn_fused` and
           `angular_aev_asn` with
           both stages against autograd through the plain forwards, both
           stages against the packed one, forward and gradients, and E, F,
           W with "blocks" on the card against the CPU (f64).
  main     the MD main path through the user's entry points (zoo.ani2x
           with repulsion, Simulation(cellroll=True), which in f32 on the
           card is the pallas_asn engine, init_state, run): ANI-2x + XTB
           repulsion at full width, one model, weights drawn from a seed,
           f32; WATER30 x 15^3 = 101,250 atoms; dt 0.5 fs, 12-step chunks. The tile was not equilibrated
           under these weights, so 12 chunks of Langevin 300 K at damp
           10 fs come first; then 2 warm and 4 timed chunks at damp 100 fs
           (the timed window is taken again if a capacity regrew in it).
           The launch counts are zeroed just before and read just after;
           the line gives ms/step, ns/day, the timed window's temperature
           drift, the sizing `Simulation` derived and the regrows by kind.
  profile  one asn MD chunk on the host clock and one under
           torch.profiler: device ms per step by group (the eight asn
           kernels by name, matrix products, wing folds, the rest) and
           the device's idle share.
  roll_md  the roll engine (pallas_full, no repulsion) from the main
           path's final positions and velocities: 1 warm and 3 timed
           chunks, its launch counts zeroed just before: its ms/step
           beside the asn engine's, and the roll kernels' inputs.
  timing   each roll kernel at the roll run's final state (f32) against
           its plain version: error, ms, plain ms, the bound (two terms)
           and the layout floor of the padded output or wing slab; two
           calls of each there bit for bit; radial_fwd into a NaN-filled
           output.
  asn_timing  at the main path's final state, after a fresh rebuild: each
           of the eight asn kernels' error, ms, plain ms, bound and launches
           per MD step (the packed ones with the pair lanes of their tier
           layouts beside the filled slot pairs); the wing kernel (a
           scatter over idx) against its plain version (a gather through
           inv) on the rebuild's tables with integer-valued lane
           cotangents, bit for bit; rebuild, forward and
           force-evaluation ms (CUDA events, three rounds); the energies
           against the plain versions on the card; with repulsion off, the
           energies against the roll engine's at the same positions (held
           in f64, reported in f32); the MLP's forward and backward ms on
           the compact columns.
  asn_channels  the per-channel surface at the same state and sizing
           (f32, 101,250 atoms, tiered as the main path), its launch
           counts zeroed just before and read just after: `radial_aev_asn`
           and `angular_aev_asn`, forward and forward + backward, beside
           `aev_asn_fused` (CUDA events, three rounds of 10, the median),
           in compact columns and once in the full layout; forwards equal
           to the fused forward bit for bit; then each of the four
           per-channel kernels' error, ms, plain ms and bound.
  blocks_md  the asn MD path with pair_stage "blocks" (two tiers under the
           per-block work model, sized by itself) from the main path's
           final positions and velocities: 1 warm and 3 timed chunks, its
           launch counts zeroed just before and read just after (the ten
           kernels of the path all launched, packed_fwd and packed_bwd and
           every plain version not); ms/step, ns/day, sizing, regrows;
           one chunk under torch.profiler; then each per-block kernel at
           the final state: error (the forwards also twice bit for bit,
           their tier pad rows exact zeros), ms, plain ms, bound, filled
           and laid-out slot pairs, launches per step;
           and one force evaluation there through each of the three pair
           stages on the same tiers (ms, forces against packed's).
  pair_stage  the pair stage alone on synthetic rows (the counterpart of
           examples/benchmark/micro_pair_stage.py at its defaults: 100,352
           rows, caps H 16 / O 8, f32): forward and backward ms of packed,
           blocks and blocks_full (three rounds of 10, the median), each
           against packed, and each per-block kernel's ms, launches per
           call, plain ms on 8,192 rows and bound.
  mirror   the mirror engine (ANI-2x + XTB repulsion) and the xla and
           pallas hybrids (no repulsion) at WATER30 x 6^3, f64: E, F, W
           at the start state on the card against the CPU; the pallas
           hybrid launches radial_fwd and radial_bwd and no plain version,
           the other two no kernel; the mirror's E, F, W against
           pallas_asn's at the same positions.
  mirror_md  the JAX CLI's defaults on the main path's model and tile:
           Simulation() (the mirror engine), 101,250 atoms, f32, the cell
           list sized as lammps_ani_tpu/run.py sizes it, Langevin 300 K,
           dt 0.5 fs, a rebuild every 12 steps, from the main path's final
           positions and velocities: 1 warm and 3 timed chunks (ms/step,
           ns/day, regrows by kind, peak memory), one chunk under
           torch.profiler (device-busy ms/step), and one force evaluation's
           forces against pallas_asn's at the final state.
  probes   the probes' entry points (lammps_ani_torch/probes: the
           counterparts of examples/benchmark/micro_kernel_variants.py,
           micro_gather.py and micro_pieces.py) at their main sizes, their
           launch counts zeroed just before and read just after; then each
           probe kernel's stage or mode (csrc/probes.cu) against its plain
           version (f32 sums within 5e-6 + 1e-5 of the entry with the same
           NaN and inf entries, each column's err / limit; the gathers
           equal), two calls of each bit for bit, each compact mode also
           into an output filled with NaN (every entry written), its ms,
           plain ms, library ms and bound (a variant's as the kernel fuses
           its sums, beside the count without the fusing; beside the
           gathers' the 32-byte sector floor, beside ONEHOT's the one-hot
           strategy's floor), and the radial forward kernel on the
           probe's grid (the JAX probes' production-kernel timings; also
           into a NaN-filled output, with its two-term bound and layout
           floor).

  nvt_npt  the main path's model and final state (101,250 atoms, f32,
           cellroll=True, so pallas_asn) under NoseHooverNPT at
           examples/water-NPT's settings (300 K, tdamp 100 fs, 1 atm,
           pdamp 500 fs), its counts zeroed just before and read just
           after: 1 warm and 3 timed chunks (ms/step, the volume and
           pressure at each chunk's end, regrows), one chunk under
           torch.profiler (device busy, idle share), the eight asn
           kernels' launches (all required, no plain version); then in
           f64 NoseHoover, NoseHooverNPT and NVE + BerendsenBarostat, two
           chunks of a step on the card against the same run on the CPU
           (pe rtol 1e-11, positions and box.h 1e-9 A) on pallas_asn at
           WATER30 x 6^3 (6,480 atoms) and on pallas_full at WATER30 x
           2^3 spread to a 17.6 A box (240 atoms: at 6,480 the plain
           roll kernels on the CPU take minutes); and a
           forced re-derive of the grid on both engines at 6,480 atoms
           (the box scaled so that its grid sits 6.5% above the engine's
           side, then by 0.93): the card's new grid and radial shell equal
           the port's `_setup_grids` on the CPU from the same state, one
           regrow event for it and one for each capacity grown.

  ani1xnr_kernels  the main path's eight asn kernels against their plain
           versions at ANI-1xnr's constants (zeta 32 by the integer power,
           4 species, Rcr 5.2 beside the repulsion's 5.1, the AEV 384
           wide), 8 models, on the combustion mixture (the port's
           examples/combustion `prepare_system.build`: 1,440 atoms at 0.25
           g/cm^3) replicated
           2^3 (11,520 atoms), sized by `Simulation`, f64 and f32, within
           the asn limits, each worst error as a fraction of its limit,
           two calls of each bit for bit, the packed kernels' edge cases;
           then E, F, W of `energy_forces_virial_asn` on the card against
           the CPU, f64, on the 1,440-atom mixture.
  ani1xnr_md  the combustion config's model and settings at 92,160 atoms
           (the mixture replicated 4^3; ANI-1xnr, 8 models, f32,
           pallas_asn, NVT 2500 K, tdamp 50 fs, dt 0.25 fs, a rebuild every
           10 steps), its counts zeroed just before and read just after:
           1 warm and 3 timed chunks (ms/step, ns/day), one profiled chunk
           (device busy, idle share, each kernel's device ms a step), the
           eight kernels' launches (all required, no plain version); then
           each kernel at the final state: error, ms, plain ms and its
           bound (ASN_OPS_1XNR).
  cli      `lammps_ani_torch.run.main` on the card on
           examples/combustion/config.json and the 1,440-atom mixture
           (the port's `prepare_system.build`, written by the port's
           writer, read back by both parsers): 200
           steps with a DCD frame every 50 (4 frames, the last the final
           positions; the thermo YAML to step 200); 100 steps with a
           restart and 100 more from it (the final positions against the
           200-step call's, bit for bit or within 1e-3 A); Langevin 40 + 40
           steps through a restart against 80 straight; `minimize_first`;
           `replicate [4, 4, 4]` for 20 steps beside the 92,160-atom data
           file parsed by the native and the Python parser.

  rattle_md  the main path's model, engine and settings (pallas_asn, f32,
           Langevin 300 K, dt 0.5 fs, 12-step chunks) on the reference
           water tile (WATER30_POS: equil_water30.npz's molecules came
           apart under the synthetic weights) x 15^3 = 101,250 atoms with
           every O-H bond constrained (67,500): the bonds from
           `fragments.bond_pairs` on the card, equal to the tile's 20
           replicated; 12 chunks at damp 10 fs while the tile relaxes,
           then a fresh engine sized at that state, its counts zeroed
           just before and read just after: 2 warm and 3 timed chunks
           (ms/step, max_violation at each chunk's end below 1e-4 A, the
           temperature over the reduced dof), one profiled chunk (device
           busy, idle share), the
           constraint stage alone (launches, device and host ms a step);
           then f64 NVE on the tile x 6^3 (6,480 atoms), 12 steps, twice
           on the card (bit for bit) and on the CPU (positions within
           1e-9 A), max_violation below 1e-8 A.
  bias_md  the main path's model and final state with `bias.combine` of a
           distance, an angle and a dihedral restraint (k 40, atoms near
           the box's center): 1 warm and 3 timed chunks (ms/step and
           device busy beside main's, each CV at each chunk's end); f64
           NVE with the restraints on 6,480 atoms, 12 steps, card against
           CPU (positions within 1e-9 A); `run_windows` over 3 windows of
           24 steps on 6,480 atoms (f32) and the port's `wham` over the
           samples (the PMF's finite values).
  trace    `utils.profiling.trace` around one chunk of the main path, then
           `summarize_trace`: its top 10; the eight asn kernels named in
           it, the sum of its entries equal to the sum of the trace's
           device-kernel events, the "nn_forward" ranges present.
  fragments  `analysis.fragments.bond_pairs` and `fragments` at
           ani1xnr_md's final state (92,160 atoms) on the card: seconds,
           pairs and formula counts; the card's pairs equal to the CPU
           path's on the mixture x 2^3 (11,520 atoms).
  equilibrate_tile  the port's tile tool on the card on the reference
           tile written by the port's `write_lammps_data`: FIRE and 1 leg
           of 100 Langevin steps into a scratch directory; finite
           positions and velocities in the written .npz.
  domain   domain decomposition on the in-process mesh
           (`parallel.sim.DomainSimulation`): f64 on the reference tile x
           4^3 (1,920 atoms, ANI-1xnr) on (1,1,1) and (2,2,2), packed and
           "blocks", against the single-device asn engine on the card (pe
           rtol 1e-11, F 1e-9, W 1e-8), two evaluations bit for bit, the
           box cotangent on brick bins exactly 0; then
           examples/early_earth/config_50k.json at full ANI-1xnr width,
           f32, mesh (2,2,2), from `load_restart` of the JAX engine's
           49,000-atom restart: the engine pallas_asn, two chunks from one
           state bit for bit, 3 timed chunks of 10 steps (every gid once
           after each, the eight asn kernels launched, counted just before
           and after), one chunk under torch.profiler, the regrows and
           sizing, the same system on the single-device engine (E and F
           at the restart, ms/step, busy), and each asn kernel on shard
           0's brick bins against its plain version; the phase's seconds.
  distributed  the process-group backend (`parallel.comm.ProcessGroupMesh`)
           on a one-rank NCCL group made in this process (a FileStore; no
           fallback to gloo), mesh (1,1,1): f64 on the reference tile x
           4^3 (1,920 atoms, ANI-1xnr, pallas_asn), the group against
           `LocalMesh`: E, F, W of one evaluation and 12 NVE steps bit for
           bit; f32, the domain phase's early-earth system from its relaxed
           start at full ANI-1xnr width as one shard: the group, then
           `LocalMesh`, then the single-device engine, each 1 warm and 3
           timed chunks of 10 steps (ms/step, ns/day, collective calls a
           step) and one chunk under torch.profiler (device busy, idle
           share); the group's engine pallas_asn, its two chunks bit for
           bit against `LocalMesh`'s, every gid once, the eight asn
           kernels launched in its timed chunks (counted just before and
           after), no plain version; then the CLI under `torchrun
           --standalone --nproc_per_node 1` on mesh 1 1 1 (NCCL; f64,
           ANI-2x, 1,920 atoms, 20 NVT steps) against its in-process route
           (`LocalMesh`): the thermo YAML, the final DCD frame and the
           restart; the phase's seconds.
  examples  the example workflows (lammps_ani_torch/examples), one line a
           part with its seconds and nvidia-smi's name and power limit:
           `run_umbrella` on the reference tile (2 windows of 24 steps, a
           dihedral across two molecules) against a direct
           `bias.run_windows` call bit for bit, then `analyze_umbrella`
           over its npz; `analyze_traj` over the cli phase's DCD against
           `analysis.fragments` on `read_dcd`'s frames; the campaign's
           `main` under `torchrun --standalone --nproc_per_node 1` (NCCL,
           mesh (1,1,1), `generate.build(480)`: 1,960 atoms, two stages of
           10 steps) against `run_campaign` on `LocalMesh` (1,1,1) in this
           process: the thermo YAML, both restarts and the final positions
           bit for bit; then examples/early_earth/config_50k.json as
           shipped (49,000 atoms from its data file, ANI-1xnr at full
           width, one model, f32, mesh (2,2,2) on `LocalMesh`) with a
           second stage of 10 steps at 500 K through `run_campaign`, its
           counts zeroed just before and read just after (the engine
           pallas_asn, the eight asn kernels launched, no plain version,
           finite thermo, the invariants; ms/step by stage, regrows by
           kind), then stage 1 again in a fresh engine from stage 0's
           restart: its thermo rows and final positions bit for bit
           against the continuous campaign's; the phase's seconds.

Then one line {"kernels": [...]} (the twenty package kernels, the probe
kernels by stage and mode, the radial forward kernel's probe timing, the
eight asn kernels' ANI-1xnr rows, `<kernel><ani1xnr>`, and their rows on
a domain's brick bins, `<kernel><domain>`), nvidia-smi's name and
power-limit line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from lammps_ani_torch import Box, NeighborConfig, Simulation
from lammps_ani_torch.examples.combustion import prepare_system
from lammps_ani_torch.io.lammps_data import LammpsData, replicate
from lammps_ani_torch.md import integrate
from lammps_ani_torch.md import simulation as simmod
from lammps_ani_torch.models import networks as netmod
from lammps_ani_torch.models import potential as potmod
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops import _build
from lammps_ani_torch.ops import aev_asn as asn
from lammps_ani_torch.ops import aev_roll as ar
from lammps_ani_torch.ops import cell_roll as crmod
from lammps_ani_torch.ops import neighbors as nbops
from lammps_ani_torch.probes._common import time_ms
from lammps_ani_torch.probes import micro_gather as pmg
from lammps_ani_torch.probes import micro_kernel_variants as pmv
from lammps_ani_torch.probes import micro_pieces as pmp

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = os.path.join(ROOT, "examples", "benchmark", "data", "equil_water30.npz")
SOURCE = "lammps_ani_torch/csrc/aev_roll.cu"
ASN_SOURCE = "lammps_ani_torch/csrc/aev_asn.cu"
PROBE_SOURCE = "lammps_ani_torch/csrc/probes.cu"
KERNELS = ("radial_fwd", "radial_bwd", "angular_fwd", "angular_bwd")
# the angular kernels' pass forms (csrc/aev_roll.cu), above the caps their
# whole-window layouts hold
PASS_FORMS = ("angular_fwd_pass", "angular_bwd_pass")
# the kernels of the MD main path, and those of the per-channel surface
ASN_KERNELS = ("build_inv", "build_idx", "step_fused", "packed_fwd",
               "radial_gamma", "packed_bwd", "chain_sum", "wing")
CHANNEL_KERNELS = ("radial_fwd_asn", "compact_asn", "radial_bwd_asn",
                   "decompact_chain")
# the per-block pair stage's kernels, and the kernels of an MD step on it
BLOCK_KERNELS = ("block_fwd", "block_fwd_tri", "block_bwd", "block_bwd_tri")
BLOCK_MD_KERNELS = tuple(k for k in ASN_KERNELS
                         if k not in ("packed_fwd", "packed_bwd")
                         ) + BLOCK_KERNELS
CHUNK = 12

# The 30-atom water tile (species H=0, O=3) and the masses of the 7 ANI-2x
# species (H, C, N, O, S, F, Cl), g/mol.
WATER30_SPECIES = np.array([3, 0, 0] * 10, np.int64)
MASSES = np.array([1.008, 12.0107, 14.0067, 15.999, 32.06, 18.998403163,
                   35.45])

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (128 lanes per SM, 2 flops per fused
# multiply-add). An add, multiply or compare on its own is one
# instruction of a lane: half that rate. The special-function unit
# (sqrt, exp2, sin, cos, reciprocal) gives 16 results per clock per SM
# against the 128 lanes (CUDA programming guide, compute capability 9.0).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F32_INSTR = PEAK_F32 / 2
PEAK_SFU = PEAK_F32 / 16

# Operations each roll kernel needs per unit of work, in two terms, as the
# asn pair kernels (ASN_OPS below): fp32 instructions of a lane (an fma
# counts once) at PEAK_F32_INSTR and special-function results at PEAK_SFU,
# the larger of the two, as (fp32, sfu) per unit of work:
#   per real candidate of a real center's 27-bin window ("window"), (8,
#     1): the offset 3, the squared distance 3 (a product and two fmas),
#     the 1e-12 clamp 1, the Rca test 1, and the square root;
#   per real candidate of a real center's shell-s radial window
#     ("window2"), (7, 0): the offset 3, the squared distance 3 and its
#     test against Rcr^2 1 (the radial kernels take the square root only
#     below that, in "rpair");
#   angular_fwd per kept neighbour ("nbr"), (11, 2): the slot (1 / d 5 and
#     a reciprocal, the unit vector 3, the live test 1, fc with its
#     argument 2 and the hardware cosine);
#   angular_bwd per kept neighbour, (34, 4): the slot (as the forward's,
#     with dfc: 13 and the sine), then its chain (1 / d 4 and a reciprocal,
#     gu . u 3, g_cd 3, the vector 6, fcen 3, the wing's add 3);
#   per slot pair ("pair"): packed_fwd's (272, 21) forward and
#     packed_bwd's (306, 21) backward (ASN_OPS);
#   radial_fwd per in-cutoff pair ("rpair"), (85, 18): the 1e-12 clamp 1,
#     the square root, the Rcr test 1, the cutoff's argument 1, fc 1 with
#     the hardware cosine, x 1, per shift (16) xk 1, geta xk^2 2, its ex2,
#     the product with fc 1 and the add to its column 1;
#   radial_bwd per in-cutoff pair ("rpair"), (144, 20): the clamp, the
#     square root and the Rcr test as radial_fwd's, the cutoff's
#     argument, fc and dfc 3 with the hardware cosine and sine, x 1, per
#     shift (16) xk 1, geta xk^2 2, its ex2, the slope and its product
#     with the cotangent 5, then gamma / d 1 and a reciprocal, g 3, fcen 3,
#     the wing's add 3.
OPS = {"radial_fwd": {"window2": (7, 0), "rpair": (85, 18)},
       "radial_bwd": {"window2": (7, 0), "rpair": (144, 20)},
       "angular_fwd": {"window": (8, 1), "nbr": (11, 2), "pair": (272, 21)},
       "angular_bwd": {"window": (8, 1), "nbr": (34, 4),
                       "pair": (306, 21)}}

# Limits of a kernel's error against its plain version: |err| <= atol +
# rtol * scale, where scale is the output's largest magnitude, or for the
# box cotangent dh (a sum over every window lane) the sum of the magnitudes
# of its terms. f32 sums taken in another order differ by a few ulps of
# that scale.
TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (5e-6, 1e-5)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Systems
# ---------------------------------------------------------------------------


def water_box(rep: int) -> LammpsData:
    """The equilibrated 30-atom tile replicated rep^3 times."""
    z = np.load(TILE)
    bounds = np.stack([z["box_origin"], z["box_origin"]
                       + np.diag(z["box_h"])], 1).astype(np.float64)
    tile = LammpsData(species=WATER30_SPECIES,
                      positions=z["positions"].astype(np.float64),
                      masses_by_type=MASSES, box_bounds=bounds,
                      tilt=np.zeros(3))
    return replicate(tile, rep, rep, rep)


def make_sim(data, dtype, device, integrator=None, rebuild_every=CHUNK,
             seed=1, engine="pallas_asn", repulsion=None, pair_stage=None,
             cellroll=False, ghost_capacity=None, barostat=None,
             constraints=None, extra_force=None):
    """A `Simulation` of ANI-2x, one model, weights drawn from `seed`, on
    `engine` (None: as `cellroll` resolves it, the user's path; the main
    path's `cellroll=True` in f32 on the card is pallas_asn); the asn
    engine and the mirror carry the XTB repulsion term, the roll engine
    (pallas_full) and the hybrids do not; `pair_stage`: the asn engine's
    angular pair stage (None: packed); `ghost_capacity` (None: max(4096,
    n / 2), which only the degree measure uses on the grid engines);
    `barostat`: a BerendsenBarostat; `constraints` (a Rattle) and
    `extra_force` as `Simulation` takes them."""
    n = data.n_atoms
    if repulsion is None:
        repulsion = engine not in ("pallas_full", "xla", "pallas")
    nbr = NeighborConfig(cutoff=5.1, skin=2.0, k_max=128,
                         ghost_capacity=ghost_capacity or max(4096, n // 2),
                         use_cell_list=n > 4096, cell_capacity=32,
                         rebuild_every=rebuild_every)
    pot = zoo.ani2x(num_models=1, seed=seed, dtype=dtype, device=device,
                    repulsion=repulsion)
    return Simulation(potential=pot, species=data.species,
                      masses=data.masses_by_type[data.species], nbr=nbr,
                      dt=0.5, integrator=integrator, dtype=dtype,
                      device=device, engine=engine, pair_stage=pair_stage,
                      cellroll=cellroll, barostat=barostat,
                      constraints=constraints, extra_force=extra_force)


def make_box(data, dtype, device):
    return Box(h=torch.tensor(data.box_h, dtype=dtype, device=device),
               origin=torch.tensor(data.box_origin, dtype=dtype,
                                   device=device))


# ---------------------------------------------------------------------------
# Kernel inputs, calls and bounds
# ---------------------------------------------------------------------------


def kernel_inputs(sim, state, seed=0):
    """The four kernels' grid inputs at a simulation state (its positions
    and the bins of its last rebuild), as the main path hands them over,
    and seeded cotangents."""
    box, pos, bins = state.box, state.pos, state.bins
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    spec = sim.potential.spec
    caps, present_a = ar.effective_caps(spec.aev, spec.angular_caps,
                                        sim.species_counts)
    nc, cap = sp_g.shape
    g = torch.Generator(device=pos.device).manual_seed(seed)
    ga_r = torch.randn((nc, cap, spec.aev.radial_length), generator=g,
                       dtype=pos.dtype, device=pos.device)
    ga_a = torch.randn((nc, cap, spec.aev.angular_length), generator=g,
                       dtype=pos.dtype, device=pos.device)
    return dict(pos_g=pos_g, sp_g=sp_g, h=box.h.contiguous(),
                ncells=sim._roll_grid.ncells, shell=sim._roll_shell,
                spec=spec.aev, caps=caps, present_a=present_a,
                present_r=ar.present_species(spec.aev, sim.species_counts),
                ga_r=ga_r, ga_a=ga_a)


def kernel_calls(k):
    """{name: (kernel call, plain call)} on the same inputs."""
    a = (k["pos_g"], k["sp_g"], k["h"], k["ncells"])
    rad = (k["shell"], k["spec"], k["present_r"])
    ang = (k["spec"], k["caps"], k["present_a"])
    return {
        "radial_fwd": (lambda: ar.radial_fwd(*a, *rad),
                       lambda: ar.radial_fwd_plain(*a, *rad)),
        "radial_bwd": (lambda: ar.radial_bwd(*a, *rad, k["ga_r"]),
                       lambda: ar.radial_bwd_plain(*a, *rad, k["ga_r"])),
        "angular_fwd": (lambda: ar.angular_fwd(*a, *ang),
                        lambda: ar.angular_fwd_plain(*a, *ang)),
        "angular_bwd": (lambda: ar.angular_bwd(*a, *ang, k["ga_a"]),
                        lambda: ar.angular_bwd_plain(*a, *ang, k["ga_a"])),
    }


def _dh_scale(ncells, shell, wing):
    """Sum of |S| |wing| over the lanes: the size of the terms of dh."""
    sh = ar._wrap_shift_tables(ncells, shell, wing.dtype, wing.device).abs()
    nc, n_off = sh.shape[:2]
    cap = wing.shape[1] // n_off
    s_lane = sh[:, :, None, :].expand(nc, n_off, cap, 3).reshape(nc, -1, 3)
    return torch.einsum("nwm,nwc->mc", s_lane, wing.abs()).max()


def compare(name, k, got, ref):
    """Errors of one kernel's outputs against its plain version's:
    {"max_abs_err", "worst_ratio" (err / limit, <= 1 passes), "outputs"}."""
    atol, rtol = TOL[k["pos_g"].dtype]
    if name == "angular_fwd":
        # the deficit is an integer: exact
        if float(got[1]) != float(ref[1]):
            raise AssertionError(f"angular_fwd deficit {float(got[1])} != "
                                 f"plain {float(ref[1])}")
        got, ref, labels = (got[0],), (ref[0],), ("aev",)
    elif name.endswith("_bwd"):
        labels = ("fcen", "wing", "dh")
    else:
        got, ref, labels = (got,), (ref,), ("aev",)
    out, worst, max_err = {}, 0.0, 0.0
    shell = k["shell"] if name.startswith("radial") else 1
    for lab, x, y in zip(labels, got, ref):
        if x.shape != y.shape:
            raise AssertionError(f"{name}.{lab}: shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}.{lab}: non-finite output")
        err = float((x - y).abs().max())
        scale = (float(_dh_scale(k["ncells"], shell, ref[1])) if lab == "dh"
                 else float(y.abs().max()))
        limit = atol + rtol * scale
        out[lab] = {"err": err, "limit": limit}
        worst = max(worst, err / limit)
        max_err = max(max_err, err)
    return {"max_abs_err": max_err, "worst_ratio": worst, "outputs": out}


def work_counts(k):
    """This input's data-dependent work: in-cutoff radial pairs, real
    (center, candidate) lanes of the 27-bin windows and of the radial
    shell-s windows, in-Rca angular neighbors kept by the caps, and angular
    slot pairs."""
    spec = k["spec"]
    nc, cap = k["sp_g"].shape
    cp, cs = ar._candidates(k["ncells"], k["pos_g"], k["sp_g"], k["h"],
                            k["shell"])
    n_off = (2 * k["shell"] + 1) ** 3
    pairs_r = 0
    for rs in ar._row_chunks(nc, cap, cp.shape[1]):
        _, _, in_cut = ar._window_geometry(k["pos_g"][rs], cp[rs], cap,
                                           (n_off - 1) // 2,
                                           spec.radial_cutoff)
        # empty slots are all parked at one point: count real atoms only
        real = ((k["sp_g"][rs] >= 0)[:, :, None]
                & (cs[rs] >= 0)[:, None, :])
        pairs_r += int((in_cut & real).sum())
    cp, cs = ar._candidates(k["ncells"], k["pos_g"], k["sp_g"], k["h"], 1)
    nbrs_a = pairs_a = 0
    for rs in ar._row_chunks(nc, cap, cp.shape[1]):
        _, _, in_cut = ar._window_geometry(k["pos_g"][rs], cp[rs], cap, 13,
                                           spec.angular_cutoff)
        n_s = []
        for s in k["present_a"]:
            c = (in_cut & (cs[rs][:, None, :] == s)).sum(-1)
            n_s.append(torch.clamp(c, max=k["caps"][s]).to(torch.float64))
        for i, a in enumerate(n_s):
            nbrs_a += float(a.sum())
            pairs_a += float((a * (a - 1) / 2).sum())
            for b in n_s[i + 1:]:
                pairs_a += float((a * b).sum())
    occ = (k["sp_g"] >= 0).sum(1).reshape(k["ncells"]).to(torch.float64)

    def lanes(shell):
        window = torch.zeros_like(occ)
        for off in ar._shell_offsets(shell):
            window += torch.roll(occ, shifts=tuple(int(o) for o in off),
                                 dims=(0, 1, 2))
        return int((occ * window).sum() - occ.sum())

    return {"radial_pairs": pairs_r, "window_lanes": lanes(1),
            "window2_lanes": lanes(k["shell"]),
            "angular_nbrs": int(nbrs_a), "angular_pairs": int(pairs_a)}


# OPS units -> work_counts keys
ROLL_UNITS = {"window": "window_lanes", "window2": "window2_lanes",
              "nbr": "angular_nbrs", "pair": "angular_pairs",
              "rpair": "radial_pairs"}


def roll_two_term_ms(name, work):
    """(fp32 ms, special-function ms) of a two-term roll kernel."""
    units = OPS[name]
    fp32 = sum(units[u][0] * work[ROLL_UNITS[u]] for u in units)
    sfu = sum(units[u][1] * work[ROLL_UNITS[u]] for u in units)
    return fp32 / PEAK_F32_INSTR * 1e3, sfu / PEAK_SFU * 1e3


def layout_floor_ms(name, k):
    """The bytes of the padded output (the forwards) or wing slab (the
    backwards) that the kernel's contract fixes, over HBM's rate (ms)."""
    nc, cap = k["sp_g"].shape
    fsize = k["pos_g"].element_size()
    if name == "angular_fwd":
        nbytes = nc * cap * k["spec"].angular_length * fsize
    elif name == "radial_fwd":
        nbytes = nc * cap * k["spec"].radial_length * fsize
    else:
        shell = k["shell"] if name.startswith("radial") else 1
        nbytes = nc * (2 * shell + 1) ** 3 * cap * 3 * fsize
    return nbytes / PEAK_BYTES * 1e3


def bound(name, k, work):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over HBM's rate and its operations (OPS, in two terms). The bytes are
    the real atoms' rows, each read or written once: positions, species
    and the box in; the AEV out (forward); the AEV cotangent in, dpos and
    dh out (backward). The grid's empty slots and the wing slabs are the
    kernels' own layout, not the function's."""
    n = int((k["sp_g"] >= 0).sum())
    fsize = k["pos_g"].element_size()
    width = (k["spec"].radial_length if name.startswith("radial")
             else k["spec"].angular_length)
    nbytes = n * 3 * fsize + n * 4 + 9 * fsize
    if name.endswith("_fwd"):
        nbytes += n * width * fsize + (4 if name == "angular_fwd" else 0)
    else:
        nbytes += n * width * fsize + n * 3 * fsize + 9 * fsize
    t_ops = max(roll_two_term_ms(name, work))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    report = _build.build_all()
    regs, fn = {}, None
    for line in "\n".join(r["log"] for r in report.values()).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = line.split(":", 1)[1].strip()
    names = {}
    for fn, used in regs.items():
        probe = re.search(r"(probe_\w+?)_kernel(?:ILi(\d+)E)?", fn)
        if probe:
            # probes.cu: probe_radial_variant_stage<n>, probe_compact_mode<n>
            # (the decompaction), probe_compact_gather_mode<n>,
            # probe_compact_affine_any, probe_compact_onehot_any
            kname, arg = probe[1], probe[2]
            suf = (("stage" if "variant" in kname else "mode") + arg
                   if arg else "any")
            names[f"{kname}_{suf}"] = used
            continue
        for kname in (*KERNELS, *PASS_FORMS, "dh_reduce",
                      *(f"asn_{k}" for k in ASN_KERNELS + CHANNEL_KERNELS
                        + BLOCK_KERNELS)):
            if f"{kname}_kernel" in fn:
                suf = ("f64" if f"{kname}_kernelId" in fn else
                       "f32" if f"{kname}_kernelIf" in fn else "any")
                names[f"{kname}_{suf}"] = used
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": names})


def same_bits(a, b):
    """Whether two tuples of float tensors agree bit for bit."""
    def bits(x):
        return x.view(torch.int64 if x.dtype == torch.float64
                      else torch.int32)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


# the roll kernels whose two calls must agree bit for bit, and the labels
# of their outputs
TWICE = {"radial_fwd": ("aev",), "angular_fwd": ("aev", "deficit"),
         "radial_bwd": ("fcen", "wing", "dh"),
         "angular_bwd": ("fcen", "wing", "dh")}


def kernel_twice(k, name):
    """Two calls of a roll kernel on `k`: {output: bit mismatches}; raises
    unless every output agrees bit for bit."""
    kern = kernel_calls(k)[name][0]
    first, second = kern(), kern()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    _sync(k["pos_g"].device)
    out = {lab: 0 if same_bits((x,), (y,)) else int((x != y).sum())
           for lab, x, y in zip(TWICE[name], first, second)}
    if any(out.values()):
        raise AssertionError(f"{name}, two calls: {out}")
    return out


def angular_fwd_truncating(k):
    """angular_fwd at caps below the measured degree (half of each cap):
    the output against the plain version's within the limit, the deficit
    equal and > 0."""
    caps = tuple(c // 2 for c in k["caps"])
    kt = dict(k, caps=caps)
    kern, plain = kernel_calls(kt)["angular_fwd"]
    got, ref = kern(), plain()
    _sync(k["pos_g"].device)
    err = compare("angular_fwd", kt, got, ref)  # raises on another deficit
    if err["worst_ratio"] > 1.0 or float(got[1]) <= 0:
        raise AssertionError(f"angular_fwd at caps {caps}: {err}, deficit "
                             f"{float(got[1])}")
    return {"caps": list(caps), "deficit": float(got[1]),
            "worst_ratio": err["worst_ratio"]}


def radial_fwd_every_entry(k, cap=None):
    """radial_fwd launched into an output filled with NaN first, against
    its plain version within the limit: an entry the kernel leaves unwritten
    stays NaN and fails `compare`. With `cap`, the grid is first padded with
    empty slots to `cap` a bin (256 is the most the wrappers take; the
    kernel's staging then runs in many passes): the grid's own rows against
    the plain version, the added rows exactly 0. Returns err / limit."""
    a = (k["pos_g"], k["sp_g"], k["h"], k["ncells"], k["shell"], k["spec"],
         k["present_r"])
    nc, c0 = k["sp_g"].shape
    cap = cap or c0
    pos_g = k["pos_g"].new_full((nc, cap, 3), 1e6)
    pos_g[:, :c0] = k["pos_g"]
    sp_g = k["sp_g"].new_full((nc, cap), -1)
    sp_g[:, :c0] = k["sp_g"]
    out = torch.full((nc, cap, k["spec"].radial_length), float("nan"),
                     dtype=k["pos_g"].dtype, device=k["pos_g"].device)
    got = ar._radial_fwd_into(out, pos_g, sp_g, *a[2:])
    ref = ar.radial_fwd_plain(*a)
    _sync(k["pos_g"].device)
    if bool((got[:, c0:] != 0).any()):
        raise AssertionError(f"radial_fwd at cap {cap}: a padded row is not "
                             f"0")
    err = compare("radial_fwd", k, got[:, :c0], ref)  # raises on a NaN left
    if err["worst_ratio"] > 1.0:
        raise AssertionError(f"radial_fwd into a NaN-filled output, shell "
                             f"{k['shell']}, cap {cap}: {err}")
    return err["worst_ratio"]


def pad_grid(k, cap, seed=11):
    """`k` with every bin padded with empty slots to `cap` (positions 1e6,
    species -1, seeded cotangents on the added rows, which no kernel may
    read: they are no center)."""
    nc, c0 = k["sp_g"].shape
    pos_g = k["pos_g"].new_full((nc, cap, 3), 1e6)
    pos_g[:, :c0] = k["pos_g"]
    sp_g = k["sp_g"].new_full((nc, cap), -1)
    sp_g[:, :c0] = k["sp_g"]
    g = torch.Generator(device=pos_g.device).manual_seed(seed)
    out = dict(k, pos_g=pos_g, sp_g=sp_g)
    for key in ("ga_r", "ga_a"):
        ga = torch.randn((nc, cap, k[key].shape[-1]), generator=g,
                         dtype=pos_g.dtype, device=pos_g.device)
        ga[:, :c0] = k[key]
        out[key] = ga
    return out


def _strip_pad(name, got, c0, n_off):
    """A padded call's outputs cut to the grid's own rows and lanes, and
    whether the padding's rows and lanes hold anything but zeros."""
    if name == "angular_fwd":
        out, deficit = got
        return (out[:, :c0], deficit), bool((out[:, c0:] != 0).any())
    fcen, wing, dh = got
    nc, cap = fcen.shape[:2]
    w = wing.view(nc, n_off, cap, 3)
    stray = bool((fcen[:, c0:] != 0).any()) or bool((w[:, :, c0:] != 0).any())
    return (fcen[:, :c0], w[:, :, :c0].reshape(nc, n_off * c0, 3), dh), stray


def angular_call(k, name, pass_form=False):
    """The angular kernel `name` on `k`, in its pass form if `pass_form`
    (even where the whole window fits: a check of the pass walk)."""
    a = (k["pos_g"], k["sp_g"], k["h"], k["ncells"], k["spec"], k["caps"],
         k["present_a"])
    if name == "angular_fwd":
        return ar.angular_fwd(*a, pass_form=pass_form)
    return ar.angular_bwd(*a, k["ga_a"], pass_form=pass_form)


def roll_at_largest_cap(k, name):
    """`name` on the grid padded with empty slots to cap 256, the most its
    host takes (radial_bwd in passes of whole offsets; the angular kernels
    at these caps too: the card's limit and the offsets it stages a pass,
    `aev_roll.angular_form`, equal to their transcriptions'), against the
    plain version on the grid's own rows: within the limit there, exact
    zeros on the padding. An angular kernel whose whole window fits at cap
    256 runs its pass form there too; at the grid's own cap its pass form
    gives the whole-window kernel's bits; cap 257 raises the named
    ValueError before any launch. Returns {"cap", "worst_ratio", ...}."""
    dev, dtype = k["pos_g"].device, k["pos_g"].dtype
    c0, cap = k["sp_g"].shape[1], ar.MAX_ANG_CAP
    out = {"cap": cap}
    if name == "radial_bwd":
        n_off = (2 * k["shell"] + 1) ** 3
        runs = {"": lambda kk: kernel_calls(kk)[name][0]()}
    else:
        n_off = 27
        lim = ar.angular_cap_limit(name, dtype, k["caps"], dev)
        form = ar.angular_form(name, cap, k["caps"], dtype, dev)
        host = (ar.angular_cap_limit(name, dtype, k["caps"]),
                ar.angular_form(name, cap, k["caps"], dtype))
        if (lim, form) != host or lim != cap or c0 >= cap:
            raise AssertionError(f"{name}: the card's cap limit and form "
                                 f"{(lim, form)}, its transcription's {host}"
                                 f" (grid cap {c0})")
        out["offsets_a_pass"] = form
        runs = {"": lambda kk: angular_call(kk, name)}
        if form == 27:
            runs["pass_form_"] = lambda kk: angular_call(kk, name, True)
    ref = kernel_calls(k)[name][1]()
    kp = pad_grid(k, cap)
    for tag, run in runs.items():
        got = run(kp)
        _sync(dev)
        got, stray = _strip_pad(name, got, c0, n_off)
        if stray:
            raise AssertionError(f"{name} {tag}at cap {cap}: a padded row "
                                 "or lane is not 0")
        err = compare(name, k, got, ref)
        if err["worst_ratio"] > 1.0:
            raise AssertionError(f"{name} {tag}at cap {cap}: {err}")
        out[f"{tag}worst_ratio"] = err["worst_ratio"]
        out[f"{tag}ms"] = time_ms(lambda: run(kp), reps=5)
    if name != "radial_bwd":
        whole, passes = angular_call(k, name), angular_call(k, name, True)
        _sync(dev)
        if not same_bits(whole, passes):
            raise AssertionError(f"{name} at grid cap {c0}: the pass form's "
                                 "bits differ from the whole window's")
        out["pass_form_same_bits_at_cap"] = c0
        out["ms_at_grid_cap"] = time_ms(lambda: angular_call(k, name), 5)
        out["pass_form_ms_at_grid_cap"] = time_ms(
            lambda: angular_call(k, name, True), 5)
        before = ar.LAUNCHES[name]
        try:
            kernel_calls(pad_grid(k, cap + 1))[name][0]()
        except ValueError as e:
            if name not in str(e) or f"cap {cap + 1}" not in str(e):
                raise
            out["above_raises"] = str(e).split(" (")[0]
        else:
            raise AssertionError(f"{name} took cap {cap + 1}, above its "
                                 f"limit {cap}")
        if ar.LAUNCHES[name] != before:
            raise AssertionError(f"{name}: launched above its limit")
    return out


def radial_bwd_interior_dh(k):
    """radial_bwd with the cotangent on the rows of the bins whose
    shell-s window is unshifted: dh exactly 0 (kernel and plain
    version); {"bins": interior bins, "dh_max": 0.0}."""
    interior = interior_bins(k["ncells"], k["pos_g"].device, k["shell"])
    if not bool(interior.any()):
        raise AssertionError(f"no interior bin at {k['ncells']}")
    ga = torch.where(interior[:, None, None], k["ga_r"], 0.0)
    a = (k["pos_g"], k["sp_g"], k["h"], k["ncells"], k["shell"], k["spec"],
         k["present_r"], ga)
    dh_k, dh_p = ar.radial_bwd(*a)[2], ar.radial_bwd_plain(*a)[2]
    _sync(k["pos_g"].device)
    if bool((dh_k != 0).any()) or bool((dh_p != 0).any()):
        raise AssertionError(f"radial_bwd, interior-only cotangent: dh "
                             f"{dh_k.tolist()} (plain {dh_p.tolist()})")
    return {"bins": int(interior.sum()), "dh_max": float(dh_k.abs().max())}


def phase_kernels_small(device, rep=6):
    """Kernels vs plain versions at WATER30 x rep^3, f64 and f32 (and the
    radial kernels at shell 1), radial_fwd into a NaN-filled output at both
    shells, two calls of each kernel bit for bit, angular_fwd at truncating
    caps, radial_bwd's dh from interior-only cotangents, and the kernels'
    backwards vs autograd through the plain forwards (f64)."""
    data = water_box(rep)
    result = {}
    for dtype in (torch.float64, torch.float32):
        sim = make_sim(data, dtype, device, engine="pallas_full")
        state = sim.init_state(data.positions, make_box(data, dtype, device))
        k = kernel_inputs(sim, state)
        errs = {}
        for kk, tag in ((k, ""), (dict(k, shell=1), "_shell1")):
            for name, (kern, plain) in kernel_calls(kk).items():
                if tag and not name.startswith("radial"):
                    continue
                got = kern()
                ref = plain()
                _sync(device)
                errs[name + tag] = compare(name, kk, got, ref)
                if errs[name + tag]["worst_ratio"] > 1.0:
                    raise AssertionError(f"{name}{tag} {dtype}: "
                                         f"{errs[name + tag]}")
        errs["radial_fwd_nan_filled_ratio"] = {
            f"shell{kk['shell']}": radial_fwd_every_entry(kk)
            for kk in (k, dict(k, shell=1))}
        errs["radial_fwd_nan_filled_ratio"]["shell2_cap256"] = (
            radial_fwd_every_entry(k, cap=256))
        errs["largest_caps"] = {
            name: roll_at_largest_cap(k, name)
            for name in ("radial_bwd", "angular_fwd", "angular_bwd")}
        errs["twice_bit_mismatches"] = {name: kernel_twice(k, name)
                                        for name in TWICE}
        errs["angular_fwd_truncating"] = angular_fwd_truncating(k)
        errs["radial_bwd_interior_dh"] = radial_bwd_interior_dh(k)
        result[str(dtype).replace("torch.", "")] = errs
        if dtype == torch.float64:
            result["autograd_f64"] = autograd_check(sim, state)
    from chip_ab import sass_counts
    result["angular_sass_f32"] = sass_counts(
        ["angular_fwd", "angular_bwd", *PASS_FORMS])
    emit({"phase": "kernels", "atoms": data.n_atoms,
          "ncells": list(sim._roll_grid.ncells), "cap": sim._roll_grid.cap,
          "shell": sim._roll_shell,
          "angular_caps": list(sim.potential.spec.angular_caps),
          **result})
    return result


def autograd_check(sim, state):
    """dE/dpos and dE/dh of E = sum(aev @ w): the autograd.Functions (the
    backward kernels on the card) against torch.autograd through the plain
    forwards, f64."""
    spec = sim.potential.spec
    grid, counts = sim._roll_grid, sim.species_counts
    box0, pos0, bins = state.box, state.pos, state.bins
    caps, present_a = ar.effective_caps(spec.aev, spec.angular_caps, counts)
    present_r = ar.present_species(spec.aev, counts)
    g = torch.Generator(device=pos0.device).manual_seed(4)
    out = {}
    for channel in ("radial", "angular"):
        width = (spec.aev.radial_length if channel == "radial"
                 else spec.aev.angular_length)
        w = torch.randn((width,), generator=g, dtype=pos0.dtype,
                        device=pos0.device)

        def grads(fn):
            pos = pos0.clone().requires_grad_(True)
            h = box0.h.clone().requires_grad_(True)
            e = torch.sum(fn(pos, Box(h=h, origin=box0.origin)) @ w)
            return torch.autograd.grad(e, (pos, h))

        def function(pos, box):
            if channel == "radial":
                return ar.radial_aev_roll(spec.aev, grid, bins, pos, box,
                                          species_counts=counts,
                                          shell=sim._roll_shell)
            return ar.angular_aev_roll(spec.aev, grid, bins, pos, box,
                                       spec.angular_caps, counts)[0]

        def plain(pos, box):
            pos_g = ar._to_grid_rows(bins.inv, pos, 1e6)
            a = (pos_g, bins.species_grid, box.h, grid.ncells)
            if channel == "radial":
                o = ar.radial_fwd_plain(*a, sim._roll_shell, spec.aev,
                                        present_r)
            else:
                o = ar.angular_fwd_plain(*a, spec.aev, caps, present_a)[0]
            return o[bins.cell, bins.slot]

        dpos_k, dh_k = grads(function)
        dpos_p, dh_p = grads(plain)
        e_pos = float((dpos_k - dpos_p).abs().max())
        e_h = float((dh_k - dh_p).abs().max())
        out[channel] = {"dpos_err": e_pos, "dpos_limit": 1e-9,
                        "dh_err": e_h, "dh_limit": 1e-8}
        if not (e_pos <= 1e-9 and e_h <= 1e-8):
            raise AssertionError(f"autograd {channel}: {out[channel]}")
        del dpos_k, dh_k, dpos_p, dh_p
        torch.cuda.empty_cache()
    return out


def phase_potential(device, rep=4):
    """E, F, W of the whole potential through the kernels on the card
    against the plain path on the CPU, f64, at the same state."""
    data = water_box(rep)
    res = {}
    for dev in (device, "cpu"):
        sim = make_sim(data, torch.float64, dev, engine="pallas_full")
        st = sim.init_state(data.positions,
                            make_box(data, torch.float64, dev))
        res[dev] = (sim, st)
    (sk, stk), (sp, stp) = res[device], res["cpu"]
    same = (sk._roll_grid == sp._roll_grid and sk._roll_shell == sp._roll_shell
            and sk.potential.spec.angular_caps
            == sp.potential.spec.angular_caps)
    e_pe = abs(float(stk.pe) - float(stp.pe)) / abs(float(stp.pe))
    e_f = float((stk.force.cpu() - stp.force).abs().max())
    e_w = float((stk.virial.cpu() - stp.virial).abs().max())
    line = {"phase": "potential", "atoms": data.n_atoms,
            "same_capacities": same, "pe": float(stk.pe),
            "pe_rel_err": e_pe, "pe_limit": 1e-11,
            "force_err": e_f, "force_limit": 1e-9,
            "virial_err": e_w, "virial_limit": 1e-8}
    emit(line)
    if not (same and e_pe <= 1e-11 and e_f <= 1e-9 and e_w <= 1e-8):
        raise AssertionError(f"potential: card vs CPU plain: {line}")


def _run_timed(sim, state, chunks, device, chunk=CHUNK):
    """`chunks` chunks of `chunk` steps, each on the host clock up to a
    synchronize: (state, thermo rows, ms/step by chunk)."""
    rows, chunk_ms = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        state, r = sim.run(state, chunk, thermo_every=1)
        _sync(device)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / chunk)
        rows += r
    return state, rows, chunk_ms


def _md_numbers(sim, rows, chunk_ms):
    ms_step = float(np.mean(chunk_ms))
    temps = [r["temp"] for r in rows]
    return {"steps_timed": len(rows), "ms_per_step": ms_step,
            "ms_per_step_by_chunk": chunk_ms,
            "ns_per_day": sim.dt * 1e-6 * 86400.0 / (ms_step * 1e-3),
            "timed_temp": {"first": temps[0], "last": temps[-1],
                           "min": min(temps), "max": max(temps),
                           "mean": float(np.mean(temps))},
            "timed_pe_first_last": [rows[0]["pe"], rows[-1]["pe"]],
            "last_row": rows[-1]}


def _check_md(name, rows, state, launches, plain):
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"{name}: a kernel was not launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"{name}: a plain version ran: {plain}")
    finite = all(np.isfinite(r[key]) for r in rows
                 for key in ("pe", "ke", "temp", "press"))
    if not (finite and bool(torch.isfinite(state.force).all())
            and bool(torch.isfinite(state.pos).all())):
        raise AssertionError(f"{name}: non-finite pe, forces, positions or "
                             "temperature")


def asn_sizing(sim):
    """What `Simulation` derived for the asn engine."""
    return {"ncells": list(sim._roll_grid.ncells), "cap": sim._roll_grid.cap,
            "sections": [list(x) for x in sim._sections], "kpad": sim.kpad,
            "angular_caps": list(sim.potential.spec.angular_caps),
            "tiers": sim._tiers and [[list(c), r] for c, r in sim._tiers],
            "k_max": sim._k_max, "pair_stage": sim.pair_stage}


def phase_main(device, rep=15, equil_chunks=12, warm_chunks=2,
               timed_chunks=4, seed=1):
    """The MD main path at 101,250 atoms on the default engine (pallas_asn,
    ANI-2x + XTB repulsion); returns (sim, state, launches, its line)."""
    data = water_box(rep)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    asn.reset_counts()
    ar.reset_counts()
    sim = make_sim(data, torch.float32, device,
                   integrator=integrate.Langevin(temp=300.0, damp=10.0,
                                                 generator=gen),
                   rebuild_every=CHUNK, seed=seed, engine=None,
                   cellroll=True)
    if sim.engine != "pallas_asn":
        raise AssertionError(f"main: cellroll=True in f32 on the card gave "
                             f"engine {sim.engine}, not pallas_asn")
    box = make_box(data, torch.float32, device)
    t0 = time.perf_counter()
    state = sim.init_state(data.positions, box, temp=300.0, seed=seed)
    _sync(device)
    t_init = time.perf_counter() - t0
    sizing_init = asn_sizing(sim)
    state, equil_rows = sim.run(state, equil_chunks * CHUNK, thermo_every=1)
    sim.integrator = integrate.Langevin(temp=300.0, damp=100.0,
                                        generator=gen)
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)
    _sync(device)
    t_setup = time.perf_counter() - t0
    regrow_equil = dict(sim.regrow_kinds)
    # a chunk that regrew a capacity ran twice: take the window again
    for attempt in range(3):
        before = sim.regrow_events
        state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device)
        if sim.regrow_events == before:
            break
    else:
        raise AssertionError("main: every timed window regrew a capacity: "
                             f"{sim.regrow_kinds}")
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    line = {"phase": "main", "engine": sim.engine, "atoms": data.n_atoms,
            "dtype": "float32", "models": 1, "repulsion": True,
            "dt_fs": sim.dt, **_md_numbers(sim, rows, chunk_ms),
            "init_state_s": t_init, "setup_equil_and_warm_s": t_setup,
            "equil": {"chunks": equil_chunks, "damp_fs": 10.0,
                      "temp_first": equil_rows[0]["temp"],
                      "temp_max": max(r["temp"] for r in equil_rows),
                      "temp_last": equil_rows[-1]["temp"]},
            "sizing_at_init": sizing_init, "sizing": asn_sizing(sim),
            "regrow_kinds_equil_and_warm": regrow_equil,
            "regrow_kinds_timed": {k: v - regrow_equil[k]
                                   for k, v in sim.regrow_kinds.items()},
            "timed_windows_taken": attempt + 1,
            "first_row": equil_rows[0], "launches": launches,
            "plain_calls": plain, "roll_launches": dict(ar.LAUNCHES),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(line)
    _check_md("main", equil_rows + warm_rows + rows, state, launches, plain)
    if any(ar.LAUNCHES.values()) or any(ar.PLAIN_CALLS.values()):
        raise AssertionError("main: the asn engine ran a roll kernel")
    if any(asn.LAUNCHES[name] for name in CHANNEL_KERNELS + BLOCK_KERNELS):
        raise AssertionError("main: the packed fused path ran a per-channel "
                             f"or a per-block kernel: {asn.LAUNCHES}")
    return sim, state, launches, line


def phase_roll_md(device, sim_asn, state_asn, warm_chunks=1, timed_chunks=3,
                  seed=1):
    """The roll engine (pallas_full, no repulsion) from the main path's
    final positions and velocities; returns (sim, state, launches, work at
    the start of the timed window)."""
    data = water_box(15)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ar.reset_counts()
    sim = make_sim(data, torch.float32, device,
                   integrator=integrate.Langevin(temp=300.0, damp=100.0,
                                                 generator=gen),
                   rebuild_every=CHUNK, seed=seed, engine="pallas_full")
    state = sim.init_state(sim_asn.positions_input_order(state_asn),
                           make_box(data, torch.float32, device),
                           vel=sim_asn.velocities_input_order(state_asn))
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)
    work_start = work_counts(kernel_inputs(sim, state))
    torch.cuda.empty_cache()
    before = sim.regrow_events
    state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device)
    launches, plain = dict(ar.LAUNCHES), dict(ar.PLAIN_CALLS)
    emit({"phase": "roll_md", "engine": sim.engine, "atoms": data.n_atoms,
          "dtype": "float32", "models": 1, "repulsion": False,
          **_md_numbers(sim, rows, chunk_ms),
          "work_timed_start": work_start,
          "regrow_events_warm": before,
          "regrow_events_timed": sim.regrow_events - before,
          "ncells": list(sim._roll_grid.ncells),
          "roll_cap": sim._roll_grid.cap, "radial_shell": sim._roll_shell,
          "angular_caps": list(sim.potential.spec.angular_caps),
          "launches": launches, "plain_calls": plain})
    _check_md("roll_md", warm_rows + rows, state, launches, plain)
    return sim, state, launches, work_start


def phase_timing(sim, state, launches, work_start):
    """Each kernel at the main path's shapes (f32): error against its plain
    version, its time and the plain version's, and its bound."""
    k = kernel_inputs(sim, state)
    work = work_counts(k)
    rows, twice, terms = [], {}, {}
    for name, (kern, plain) in kernel_calls(k).items():
        got, ref = kern(), plain()
        _sync(k["pos_g"].device)
        err = compare(name, k, got, ref)
        if err["worst_ratio"] > 1.0:
            raise AssertionError(f"{name} at the main path's shapes: {err}")
        b_ms, b_by = bound(name, k, work)
        del got, ref
        ms = time_ms(kern, reps=10, warm=2)
        plain_ms = time_ms(plain, reps=2, warm=1)
        torch.cuda.empty_cache()
        if name in TWICE:
            twice[name] = kernel_twice(k, name)
        terms[name] = dict(zip(("fp32_ms", "sfu_ms"),
                               roll_two_term_ms(name, work)))
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": ar.REPLACES[name].split()[0],
            "launches": launches[name], "max_abs_err": err["max_abs_err"],
            "err_over_limit": err["worst_ratio"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "layout_floor_ms": layout_floor_ms(name, k)})
    emit({"phase": "timing", "ncells": list(k["ncells"]),
          "cap": int(k["sp_g"].shape[1]),
          "atoms": int((k["sp_g"] >= 0).sum()), "work": work,
          "twice_bit_mismatches": twice, "two_term_ms": terms,
          "radial_fwd_nan_filled_ratio": radial_fwd_every_entry(k),
          "work_change_over_timed_window": {
              key: work[key] / work_start[key] - 1.0 for key in work},
          "outputs": {r["name"]: r for r in rows}})
    return rows


def _busy_ms(intervals):
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_events(prof):
    """The device's events of a torch.profiler run: kernels and copies,
    not the ranges that `record_function` labels (the engines'
    "nn_forward") project onto the device's timeline, which span the gaps
    between their kernels."""
    events = prof.events()
    labels = {ev.name for ev in events
              if getattr(ev, "is_user_annotation", False)}
    return [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name not in labels]


def device_time(prof, calls, group_keys):
    """(device busy ms, device ms by group, the 25 largest kernels' ms),
    each per call, from a torch.profiler run over `calls` calls."""
    by_name, intervals = {}, []
    for ev in device_events(prof):
        dur = ev.time_range.end - ev.time_range.start
        by_name[ev.name] = by_name.get(ev.name, 0.0) + dur / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    groups = {}
    for name, ms in by_name.items():
        g = next((g for g, keys in group_keys
                  if any(key in name for key in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    return (_busy_ms(intervals) / calls, groups,
            [[n[:120], ms / calls] for n, ms in top])


# ---------------------------------------------------------------------------
# The asn path (ops/aev_asn.py): kernel inputs, calls, bounds
# ---------------------------------------------------------------------------

# Operations per unit of work. build_idx and wing count every operation at
# the fused multiply-add rate:
#   build_idx, per table lane: load and compare 2;
#   wing, per assigned lane: 3 adds.
# The other kernels count fp32 instructions of a lane ("fp32", an fma
# counts once) at PEAK_F32_INSTR and special-function results ("sfu") at
# PEAK_SFU, the larger of the two, as (fp32, sfu) per unit of work:
#   build_inv, per real candidate of a real center's 27-bin window
#     ("window"), (9, 0): the offset 3, the squared distance rounded per
#     operation 5, the keep test 1 (the species and rank arithmetic is
#     integer).
# The step forward (step_fused; its
# radial part alone, radial_fwd_asn; its stage 2 alone, compact_asn), as
# (fp32, sfu) per unit of work:
#   per assigned compact lane ("keep"), (15, 1): the offset 3, the
#     squared distance rounded per operation 5, the 1e-12 clamp 2, the
#     square root's refinement 3 and its rsqrt, the Rcr and Rca tests 2;
#   per lane within Rcr ("rcr"), (148, 17): the cutoff cosine (argument,
#     0.5 c + 0.5, x 0.25: 3, one hardware cosine), x = d - mu0 1, 16
#     shifts x 9 (shift, square and scale 2, flush test and select 2, the
#     product with the cutoff 1, test and select against pmin 2, add 1)
#     and 16 ex2;
#   per lane within the repulsion cutoff ("rep"), (27, 5): r_b, r_b^1.5
#     by a square root (4 and its rsqrt), the exponent and its scale 2 and
#     an ex2, z / r_b (3 and a reciprocal), the core product 1, x = d / rc,
#     its square and clamp, u and 1 - 1 / u 6 and a reciprocal, the
#     envelope's exponent 1 and an ex2, the half product 2, the flush 3,
#     the add 1;
#   per lane with a packed slot ("kept"), (12, 3): 1 / d (3 and a
#     reciprocal), the unit vector 3, the live and in-cutoff tests 3, the
#     argument, fc and dfc 3, one hardware cosine and sine.
# step_fused counts all four; radial_fwd_asn the first three;
# compact_asn the first and the last.
# The radial backward (radial_gamma; radial_bwd_asn with its sums):
#   per assigned lane ("keep"), (19, 2): the step's geometry (15, 1), then
#     gamma / d by the reciprocal (1 and a reciprocal) and its three
#     products with a 3;
#   per lane within Rcr ("rcr"), (166, 18): the cutoff's argument 1, fc 1,
#     dfc 1, the hardware cosine and sine with their argument scales 2,
#     x = d - mu0 1, 16 shifts x 10 (shift 1, the exponent's square and
#     scale 2, flush test and select 2, 2 eta xk 1, dfc - (2 eta xk) fc 1,
#     0.25 e 1, its product 1, the weighted add 1) and 16 ex2;
#   per lane within the repulsion cutoff ("rep"), (38, 7): r_b 1, r_b^1.5
#     by a square root (4 and its rsqrt), z / r_b 1, the core's exponent
#     (3 and an ex2) and product 1, dcore 6, x = d / rc 1, the envelope:
#     x^2, clamp, u, 1 / u, 1 - 1 / u 6, its exponent (2 and an ex2), denv
#     5; the half sum 4, the weighted add 1, the three cutoff tests 3; the
#     reciprocals of r_b, rc, u and rc u^2 (4);
#   radial_bwd_asn, per assigned lane, also the center force's 3 adds
#     ("keep", (22, 2)), and per assigned lane of a bin on the grid's faces
#     ("keep_face") the nine dh terms (9, 0); an interior bin's shifts are
#     all 0 and its rows add none.
# The slot chain (chain_sum; decompact_chain without the radial part):
#   per filled slot ("kept"), (17, 1): 1 / d (1 and a reciprocal), the
#     live test 1, gu . u 3, g_cd 2 and its select 1, the vector 6, the
#     gather's add at its lane 3 (decompact_chain (14, 1): its gather adds
#     to 0);
#   per assigned lane ("keep"), (3, 0): the center force;
#   per assigned lane of a face bin ("keep_face"), (9, 0): dh.
# The packed pair kernels (and the per-block ones, which compute the same
# pair terms), per slot pair of filled slots ("pairs"), likewise in two
# terms:
#   packed_fwd, fp32 272: cosine 6 (dot 3, clamp 2, x 0.95), sine 1, fc12
#     and the clamped radial mean 5, 4 radial shifts x 6 (shift, square,
#     scale, the exponent's log2 e, flush test and select), 8 angle bases
#     x 3, 8 powers base^14.1 x 10 (square and its error 2, square and
#     multiply to base^12 3, the error term 3, f log2 base 1, the product
#     1), 32 columns x 4 (product, flush test, select, add) and fc12 e_j 4;
#     sfu 21: the square root, 4 ex2 of the shifts, lg2 and ex2 of each
#     power;
#   packed_bwd, fp32 306: the forward's terms without the columns 140, the
#     chain rule 156 (8 angle sections x 15: df1 4, df2 4, dbase 3, dcos 4;
#     drmean 24, dfc12 4, fc12 e_j 4, c95 / sv 1, the clamp test 2, the
#     scale of drmean 1), both slots' sums 10 (5 per arm); sfu 21.
STEP_OPS = {"keep": (15, 1), "rcr": (148, 17), "rep": (27, 5),
            "kept": (12, 3)}
GAMMA_OPS = {"keep": (19, 2), "rcr": (166, 18), "rep": (38, 7)}
ASN_OPS = {"build_inv": {"window": (9, 0)}, "build_idx": {"lane": 2},
           "step_fused": STEP_OPS,
           "packed_fwd": {"pairs": (272, 21)},
           "radial_gamma": GAMMA_OPS,
           "packed_bwd": {"pairs": (306, 21)},
           "chain_sum": {"kept": (17, 1), "keep": (3, 0),
                         "keep_face": (9, 0)},
           "wing": {"lane": 3},
           "radial_fwd_asn": {u: STEP_OPS[u] for u in ("keep", "rcr",
                                                       "rep")},
           "compact_asn": {u: STEP_OPS[u] for u in ("keep", "kept")},
           "radial_bwd_asn": {**GAMMA_OPS, "keep": (22, 2),
                              "keep_face": (9, 0)},
           "decompact_chain": {"kept": (14, 1), "keep": (3, 0),
                               "keep_face": (9, 0)}}


def two_term(name, ops=ASN_OPS):
    """Whether `ops` (ASN_OPS) counts `name` in two terms ((fp32, sfu)
    tuples)."""
    return isinstance(next(iter(ops[name].values())), tuple)


def two_term_ms(name, work, ops=ASN_OPS):
    """(fp32 ms, special-function ms) of a two-term kernel on `work`: the
    sum over its units u of ops[name][u] x work[u]."""
    units = ops[name]
    fp32 = sum(units[u][0] * work[u] for u in units)
    sfu = sum(units[u][1] * work[u] for u in units)
    return fp32 / PEAK_F32_INSTR * 1e3, sfu / PEAK_SFU * 1e3


def asn_inputs(sim, pos, box, seed=0, n_out=None):
    """The asn kernels' inputs as the paths hand them over, at the
    wrapped positions `pos`, after a fresh rebuild: grid inputs; inv and
    idx; the forward's residuals (slots, rank2, the rows of each packed
    call); seeded cotangents of (radial, erep, angular) and what the
    backward makes of them on the way (ga, and ga_full, the same cotangent
    in the full radial column layout; gr, the tier cotangents, gsum,
    gt). `n_out`: AEV rows for the first n_out binned atoms only (a
    domain's owned atoms, `domain_shard_inputs`)."""
    spec = sim.potential.spec
    grid, sections, caps = sim._roll_grid, sim._sections, spec.angular_caps
    bins, a = sim._bins(pos, box)
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    h = box.h.contiguous()
    static = (spec.aev, tuple(grid.ncells), sections, caps, sim._tiers,
              spec.repulsion, sim.pair_stage)
    out, (cmp, rank2, part) = asn._forward(
        static, pos, h, bins.inv, bins.species_grid, bins.cell, bins.slot,
        a.idx, asn._KERNELS, n_out)
    g = torch.Generator(device=pos.device).manual_seed(seed)
    g_rad, g_rep, g_ang = (torch.randn(o.shape, generator=g, dtype=pos.dtype,
                                       device=pos.device) for o in out[:3])
    n_all = bins.cell.shape[0]
    ga = asn._cotangent_grid_rows(bins.inv, g_rad, g_rep, n_all)
    # the full layout: the sections' column blocks at species * 16, the
    # repulsion cotangent last
    col0, srl_full = asn._radial_layout(spec.aev, sections, False)
    nr = ga.shape[-1] // len(sections)
    ga_full = ga.new_zeros(ga.shape[:2] + (srl_full + 1,))
    for si, c0 in enumerate(col0):
        ga_full[..., c0:c0 + nr] = ga[..., si * nr:(si + 1) * nr]
    ga_full[..., -1] = ga[..., -1]
    a_offs, atot = asn._a_offsets(sections, caps)
    n = g_ang.shape[0]
    if part["tiers"] is None:
        cat = part["cats"][0]
        packed = [(cat, caps, torch.nn.functional.pad(
            g_ang, (0, 0, 0, cat.shape[0] - n)))]
    else:
        ga_pad = torch.nn.functional.pad(
            g_ang, (0, 0, 0, part["pos_of"].shape[0] - n))
        packed = [(cat_t, caps_t,
                   torch.where(valid[:, None], ga_pad[row_at], 0.0))
                  for (caps_t, _), cat_t, row_at, valid in zip(
                      part["tiers"], part["cats"], part["row_at"],
                      part["valid"])]
    gr = asn.radial_gamma(pos_g, sp_g, h, a.idx, ga, grid.ncells, spec.aev,
                          sections, spec.repulsion)
    gsum = asn._angular_gsum_grid(spec.aev, sections, caps, n, bins.inv,
                                  g_ang, part, asn._KERNELS, n_all,
                                  pair_stage=sim.pair_stage)
    gt, _, _ = asn.chain_sum(rank2, a.idx, cmp, gsum, gr, grid.ncells,
                             spec.aev)
    return dict(pos_g=pos_g, sp_g=sp_g, h=h, bins=bins, a=a, cmp=cmp,
                rank2=rank2, packed=packed, part=part, g_ang=g_ang, ga=ga,
                ga_full=ga_full, gr=gr,
                gsum=gsum, gt=gt,
                ncells=grid.ncells, spec=spec, sections=sections, caps=caps,
                kpad=sim.kpad, a_offs=a_offs, atot=atot,
                keep_r=spec.cutoff + sim.nbr.skin, n=n)


def asn_calls(k, compact_cols=True):
    """{name: (kernel call, plain call)} on the same inputs; the radial
    per-channel kernels in compact columns or in the full layout."""
    spec, aev = k["spec"], k["spec"].aev
    g = (k["pos_g"], k["sp_g"], k["h"])
    idx, inv = k["a"].idx, k["a"].inv
    build = (k["ncells"], k["sections"], k["kpad"], k["keep_r"])
    step = (idx, k["ncells"], aev, k["sections"], k["caps"], spec.repulsion)
    gam = (idx, k["ga"], k["ncells"], aev, k["sections"], spec.repulsion)
    chain = (k["rank2"], idx, k["cmp"], k["gsum"], k["gr"], k["ncells"], aev)
    ao = k["a_offs"]
    rfwd = (idx, k["ncells"], aev, k["sections"], spec.repulsion,
            compact_cols)
    rbwd = (idx, k["ga"] if compact_cols else k["ga_full"], k["ncells"], aev,
            k["sections"], spec.repulsion, compact_cols)
    cpt = (idx, k["ncells"], aev, k["sections"], k["caps"])
    dchain = (k["rank2"], idx, k["cmp"], k["gsum"], k["ncells"], aev)
    return {
        "build_inv": (lambda: asn.build_inv(*g, *build),
                      lambda: asn.build_inv_plain(*g, *build)),
        "build_idx": (lambda: (asn.build_idx(inv, k["kpad"]),),
                      lambda: (asn.build_idx_plain(inv, k["kpad"]),)),
        "step_fused": (lambda: asn.step_fused(*g, *step),
                       lambda: asn.step_fused_plain(*g, *step)),
        "packed_fwd": (
            lambda: [asn.packed_fwd(c, aev, ct, ao) for c, ct, _ in
                     k["packed"]],
            lambda: [asn.packed_fwd_plain(c, aev, ct, ao) for c, ct, _ in
                     k["packed"]]),
        "radial_gamma": (lambda: (asn.radial_gamma(*g, *gam),),
                         lambda: (asn.radial_gamma_plain(*g, *gam),)),
        "packed_bwd": (
            lambda: [asn.packed_bwd(c, gc, aev, ct, ao) for c, ct, gc in
                     k["packed"]],
            lambda: [asn.packed_bwd_plain(c, gc, aev, ct, ao) for c, ct, gc
                     in k["packed"]]),
        "chain_sum": (lambda: asn.chain_sum(*chain),
                      lambda: asn.chain_sum_plain(*chain)),
        "wing": (lambda: (asn.wing(k["gt"], inv, idx),),
                 lambda: (asn.wing_plain(k["gt"], inv),)),
        "radial_fwd_asn": (lambda: (asn.radial_fwd_asn(*g, *rfwd),),
                           lambda: (asn.radial_fwd_asn_plain(*g, *rfwd),)),
        "compact_asn": (lambda: asn.compact_asn(*g, *cpt),
                        lambda: asn.compact_asn_plain(*g, *cpt)),
        "radial_bwd_asn": (lambda: asn.radial_bwd_asn(*g, *rbwd),
                           lambda: asn.radial_bwd_asn_plain(*g, *rbwd)),
        "decompact_chain": (lambda: asn.decompact_chain(*dchain),
                            lambda: asn.decompact_chain_plain(*dchain)),
    }


# each asn kernel's outputs, and which are integers (compared exactly)
ASN_OUTPUTS = {"build_inv": (("inv", True), ("ovf", True)),
               "build_idx": (("idx", True),),
               "step_fused": (("rad", False), ("cmp", False),
                              ("rank2", True), ("deficit", True)),
               "radial_gamma": (("gr", False),),
               "chain_sum": (("gt", False), ("fcen", False), ("dh", False)),
               "wing": (("wing", False),),
               "radial_fwd_asn": (("rad", False),),
               "compact_asn": (("cmp", False), ("rank2", True),
                               ("deficit", True)),
               "radial_bwd_asn": (("g", False), ("fcen", False),
                                  ("dh", False)),
               "decompact_chain": (("gt", False), ("fcen", False),
                                   ("dh", False))}


def _chain_dh_scale(k, gt):
    """Sum of |S| |gt| over the lanes: the size of the terms of the dh of
    chain_sum, decompact_chain and radial_bwd_asn (gt: their first
    output)."""
    cap = k["sp_g"].shape[1]
    sh = ar._wrap_shift_tables(k["ncells"], 1, gt.dtype, gt.device).abs()
    sh = torch.nn.functional.pad(sh, (0, 0, 0, 1))
    total = gt.new_zeros((3, 3))
    idx = k["a"].idx
    for rs in asn._chunks(idx.shape[0], cap * idx.shape[2] * 16):
        o_k = torch.clamp(idx[rs].to(torch.int64) // cap, max=27)
        s_k = torch.gather(sh[rs], 1, o_k.reshape(o_k.shape[0], -1, 1)
                           .expand(-1, -1, 3)).reshape(*o_k.shape, 3)
        total += torch.einsum("nakm,nack->mc", s_k, gt[rs].abs())
    return float(total.max())


def asn_compare(name, k, got, ref):
    """Integer outputs must be equal; floats within TOL of the output's
    largest magnitude (dh: of the sum of its terms' magnitudes). Raises on
    a mismatch."""
    atol, rtol = TOL[k["pos_g"].dtype]
    labels = (ASN_OUTPUTS[name] if name in ASN_OUTPUTS else
              tuple((f"tier{i}", False) for i in range(len(got))))
    out, worst, max_err = {}, 0.0, 0.0
    for (lab, exact), x, y in zip(labels, got, ref):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}.{lab}: {tuple(x.shape)} {x.dtype} "
                                 f"!= plain {tuple(y.shape)} {y.dtype}")
        if exact:
            n_diff = int((x != y).sum())
            out[lab] = {"mismatches": n_diff}
            if n_diff:
                raise AssertionError(f"{name}.{lab}: {n_diff} entries differ "
                                     "from the plain version")
            continue
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}.{lab}: non-finite output")
        err = float((x - y).abs().max()) if x.numel() else 0.0
        scale = (_chain_dh_scale(k, ref[0]) if lab == "dh"
                 else float(y.abs().max()) if y.numel() else 0.0)
        limit = atol + rtol * scale
        out[lab] = {"err": err, "limit": limit}
        worst = max(worst, err / limit)
        max_err = max(max_err, err)
    if worst > 1.0:
        raise AssertionError(f"{name} {k['pos_g'].dtype}: {out}")
    return {"max_abs_err": max_err, "worst_ratio": worst, "outputs": out}


def asn_work(k):
    """This input's data-dependent work: real (center, candidate) lanes of
    the 27-bin windows; assigned compact lanes ("keep"), those of the rows
    of bins on the grid's faces ("keep_face"), and those within Rcr and
    within the repulsion cutoff (every species of the model has a
    repulsion charge); filled packed slots ("kept") and filled slot
    pairs of the AEV rows ("pairs": where `k` has n_aev, of the slots of
    atom rows below it only)."""
    sp_g, idx = k["sp_g"], k["a"].idx
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    wpad = asn._round_lane(27 * cap)
    occ = (sp_g >= 0).sum(1).reshape(k["ncells"]).to(torch.float64)
    window = torch.zeros_like(occ)
    for off in ar._shell_offsets(1):
        window += torch.roll(occ, shifts=tuple(int(o) for o in off),
                             dims=(0, 1, 2))
    cp = asn._padded_candidates(k["ncells"], k["pos_g"], sp_g, k["h"], wpad)
    rep = k["spec"].repulsion
    face = ~interior_bins(k["ncells"], sp_g.device)
    keep = keep_face = rcr = n_rep = 0
    for rs in asn._chunks(nc, cap * kpad * 24):
        _, _, _, valid, dist = asn._lane_geometry(
            cp[rs], k["pos_g"][rs], idx[rs].to(torch.int64), wpad)
        keep += int(valid.sum())
        keep_face += int((valid & face[rs, None, None]).sum())
        rcr += int((valid & (dist <= k["spec"].aev.radial_cutoff)).sum())
        if rep is not None:
            n_rep += int((valid & (dist < rep.cutoff)).sum())
    real = (sp_g >= 0)[:, :, None]
    filled = (k["cmp"][:, :, 3] < k["spec"].aev.angular_cutoff + 1.0) & real
    # the packed calls take the AEV rows only: a domain's owned atoms (the
    # first n_aev rows), not its ghosts
    rows = (k["bins"].inv < k["n_aev"])[:, :, None] if "n_aev" in k else real
    counts = [(filled & rows)[:, :, off:off + a_s].sum(-1).to(torch.float64)
              for off, a_s in k["a_offs"].values()]
    pairs = 0.0
    for i, c in enumerate(counts):
        pairs += float((c * (c - 1) / 2).sum())
        for d in counts[i + 1:]:
            pairs += float((c * d).sum())
    return {"window": int((occ * window).sum()) - k["n"], "keep": keep,
            "keep_face": keep_face, "rcr": rcr, "rep": n_rep,
            "kept": int(filled.sum()), "pairs": int(pairs)}


def interior_bins(ncells, device, shell=1):
    """[NC] bool: bins whose shell-`shell` window (27 bins at shell 1)
    stays inside the grid (every wrap shift 0), in the grid's bin order (x
    outermost)."""
    ax = [(torch.arange(m, device=device) >= shell) & (torch.arange(
        m, device=device) < m - shell) for m in ncells]
    return (ax[0][:, None, None] & ax[1][None, :, None]
            & ax[2][None, None, :]).reshape(-1)


def asn_bound(name, k, work, ops_table=ASN_OPS):
    """(bound_ms, bound_by) of one call of an asn kernel (of its calls of
    one step, one per tier, for the packed ones), from this run's data.
    Bytes: the real atoms' rows, each input read once and each output
    written once (n atoms, the packed calls' rows n_aev where a domain's
    AEV rows are its owned atoms only; f the float size; the tables
    int16): positions,
    species and the box; inv rows (wpad), idx and rank2 rows (kpad); rad
    and its cotangent (srl + 1); the packed slots (6 atot) and their
    cotangents (5 atot); each packed row's 5 atot fields and its columns;
    the lane cotangents gr and gt (3 kpad each); fcen (3) and dh (9); the
    wing (27 x 3 per grid slot). The wing reads gt, and chain_sum gr, of
    the assigned lanes only (3 per "keep" lane: a dead lane's cotangent is
    0 and adds nothing); the wing reads its mapping as idx (kpad), the
    lesser of the two tables that encode it; the chains read 5 of the 6
    slot planes (ux, uy, uz, d, dfc; not fc). The per-channel kernels
    move their fused siblings' rows less what they leave out:
    radial_fwd_asn no slots and no rank2, compact_asn no rad,
    radial_bwd_asn radial_gamma's rows with fcen and dh, decompact_chain
    chain_sum's without gr. Operations: ASN_OPS on `work` (`ops_table`:
    ASN_OPS, or another model's count; the packed calls' slot pairs those
    of the AEV rows, n_aev where it is set, as `asn_work` counts them)."""
    n, f = k["n"], k["pos_g"].element_size()
    cap = k["sp_g"].shape[1]
    wpad, kpad, atot = asn._round_lane(27 * cap), k["kpad"], k["atot"]
    srl1 = k["ga"].shape[-1]
    ncols = k["packed"][0][2].shape[1]
    ops, n_ops = ops_table[name], None
    base_in = n * (3 * f + 4) + 9 * f
    if name == "build_inv":
        nbytes = base_in + n * wpad * 2
    elif name == "build_idx":
        nbytes = n * (wpad + kpad) * 2
        n_ops = ops["lane"] * n * (wpad + kpad)
    elif name == "step_fused":
        nbytes = (base_in + n * kpad * 2 + n * srl1 * f + n * 6 * atot * f
                  + n * kpad * 2)
    elif name == "packed_fwd":
        nbytes = k.get("n_aev", n) * (5 * atot + ncols) * f
    elif name == "radial_gamma":
        nbytes = base_in + n * kpad * 2 + n * srl1 * f + n * 3 * kpad * f
    elif name == "packed_bwd":
        nbytes = k.get("n_aev", n) * (10 * atot + ncols) * f
    elif name in ("chain_sum", "decompact_chain"):
        gr = work["keep"] * 3 * f if name == "chain_sum" else 0
        nbytes = (n * kpad * 4 + n * 10 * atot * f + gr + n * 3 * kpad * f
                  + n * 3 * f + 9 * f)
    elif name == "radial_fwd_asn":
        nbytes = base_in + n * kpad * 2 + n * srl1 * f
    elif name == "compact_asn":
        nbytes = base_in + n * kpad * 2 + n * 6 * atot * f + n * kpad * 2
    elif name == "radial_bwd_asn":
        nbytes = (base_in + n * kpad * 2 + n * srl1 * f + n * 3 * kpad * f
                  + n * 3 * f + 9 * f)
    else:  # wing: gt of the assigned lanes, the mapping as idx
        nbytes = work["keep"] * 3 * f + n * kpad * 2 + n * 27 * 3 * f
        n_ops = ops["lane"] * work["keep"]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (max(two_term_ms(name, work, ops_table))
             if two_term(name, ops_table) else n_ops / PEAK_F32 * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def _to_cpu(bins, a):
    """The rebuild's tables on the CPU."""
    bins_c = crmod.RollBins(**{f.name: getattr(bins, f.name).cpu()
                               for f in dataclasses.fields(crmod.RollBins)})
    return bins_c, asn.Assignment(idx=a.idx.cpu(), inv=a.inv.cpu(),
                                  ovf=a.ovf.cpu(), ovf_sec=a.ovf_sec.cpu())


def packed_edge_cases(k):
    """The packed kernels against their plain versions on two cases made
    from each tier's rows: every slot parked (u = 0, d = 2 Rca + 10, fc =
    0: the tier pad row), where both must give exact zeros, and one live
    slot per section (each section's slots after its first parked), where
    the backward's fc cotangents of the parked slots come from the closed
    form and must be nonzero in some tier. Raises beyond TOL."""
    aev, ao, atot = k["spec"].aev, k["a_offs"], k["atot"]
    out, fc_nonzero = {}, 0
    for i, (cat, caps_t, ga) in enumerate(k["packed"]):
        pad = asn._tier_pad_row(atot, aev.angular_cutoff, cat.dtype,
                                cat.device)
        one = cat.clone().reshape(-1, 5, atot)
        for off, a_s in ao.values():
            one[:, :, off + 1:off + a_s] = pad.reshape(5, atot)[
                :, off + 1:off + a_s]
        cases = {"all_parked": pad.expand(cat.shape[0], -1).contiguous(),
                 "one_live_slot": one.reshape(-1, 5 * atot).contiguous()}
        for case, rows in cases.items():
            got = [asn.packed_fwd(rows, aev, caps_t, ao),
                   asn.packed_bwd(rows, ga, aev, caps_t, ao)]
            ref = [asn.packed_fwd_plain(rows, aev, caps_t, ao),
                   asn.packed_bwd_plain(rows, ga, aev, caps_t, ao)]
            _sync(rows.device)
            res = {name: asn_compare(name, k, [x], [y])
                   for name, x, y in zip(("packed_fwd", "packed_bwd"), got,
                                         ref)}
            if case == "all_parked":
                if got[0].any() or got[1].any():
                    raise AssertionError(f"packed, tier {i}: all-parked rows "
                                         "give nonzero outputs")
            else:
                fc = got[1].reshape(-1, 5, atot)[:, 4]
                parked = rows.reshape(-1, 5, atot)[:, 4] == 0
                res["parked_fc_nonzero"] = int((fc[parked] != 0).sum())
                fc_nonzero += res["parked_fc_nonzero"]
            out[f"tier{i}_{case}"] = res
    if not fc_nonzero:
        raise AssertionError("packed: no parked slot took an fc cotangent")
    return out


def zero_row_checks(k):
    """radial_gamma and chain_sum, kernels and plain versions, on `k`'s
    inputs: exact zeros on every lane of a row with no atom and on every
    dead lane; and the box cotangent of chain_sum (kernel and plain),
    decompact_chain and radial_bwd_asn with their cotangents kept on the
    rows of interior bins only (every wrap shift 0) and zeroed elsewhere:
    exactly 0, where those rows' lane cotangents are not all 0. Raises
    otherwise."""
    sp_g, idx, aev = k["sp_g"], k["a"].idx, k["spec"].aev
    cap = sp_g.shape[1]
    empty = (sp_g < 0)[:, :, None, None]
    dead = (idx.to(torch.int32) >= 27 * cap)[:, :, None, :]
    interior = interior_bins(k["ncells"], idx.device)
    out = {"empty_rows": int(empty.sum()), "dead_lanes": int(dead.sum()),
           "interior_rows": int(interior.sum()) * cap}
    calls = asn_calls(k)
    for name in ("radial_gamma", "chain_sum"):
        for which, fn in zip(("kernel", "plain"), calls[name]):
            x = fn()[0]
            out[f"{name}_{which}_nonzero"] = int(
                ((x != 0) & (empty | dead)).sum())

    def inner(t):
        m = interior.reshape((-1,) + (1,) * (t.dim() - 1))
        return torch.where(m, t, 0.0).contiguous()

    chain = (k["rank2"], idx, k["cmp"], inner(k["gsum"]))
    gt, _, dh_chain = asn.chain_sum(*chain, inner(k["gr"]), k["ncells"], aev)
    dhs = {"chain_sum": dh_chain,
           "chain_sum_plain": asn.chain_sum_plain(
               *chain, inner(k["gr"]), k["ncells"], aev)[2],
           "decompact_chain": asn.decompact_chain(*chain, k["ncells"],
                                                  aev)[2],
           "radial_bwd_asn": asn.radial_bwd_asn(
               k["pos_g"], sp_g, k["h"], idx, inner(k["ga"]), k["ncells"],
               aev, k["sections"], k["spec"].repulsion)[2]}
    _sync(idx.device)
    out["interior_gt_nonzero"] = int((gt != 0).sum())
    out.update({f"{name}_dh_nonzero": int((dh != 0).sum())
                for name, dh in dhs.items()})
    bad = {key: v for key, v in out.items()
           if (key.endswith("_nonzero") and key != "interior_gt_nonzero"
               and v) or (not key.endswith("_nonzero") and not v)}
    if bad or not out["interior_gt_nonzero"]:
        raise AssertionError(f"zero rows, dead lanes, interior dh: {out}")
    return out


def build_inv_empty_rows(k):
    """build_inv, kernel and plain version, on `k`'s grid: the two tables
    and overflows equal, and every entry of each row with no atom kpad - 1
    (the kernel fills such a row without a scan). Raises otherwise."""
    calls = asn_calls(k)["build_inv"]
    (inv, ovf), (inv_p, ovf_p) = calls[0](), calls[1]()
    _sync(inv.device)
    empty = k["sp_g"] < 0
    out = {"empty_rows": int(empty.sum()),
           "inv_mismatches": int((inv != inv_p).sum()),
           "ovf_mismatches": int((ovf != ovf_p).sum()),
           "empty_row_entries_not_dead": int(
               (inv[empty] != k["kpad"] - 1).sum()),
           "plain_empty_row_entries_not_dead": int(
               (inv_p[empty] != k["kpad"] - 1).sum())}
    if not out["empty_rows"] or any(v for key, v in out.items()
                                    if key != "empty_rows"):
        raise AssertionError(f"build_inv on a grid with empty rows: {out}")
    return out


def phase_asn_kernels(device, rep=6):
    """The twelve asn kernels against their plain versions at WATER30 x
    rep^3 (f64 and f32; the radial per-channel kernels in both column
    layouts); the zero rows and interior dh (`zero_row_checks`); build_inv
    on the grid's empty rows (`build_inv_empty_rows`); the
    backwards of the three entry points against autograd
    through the plain forwards (f64), two calls bit for bit (f64 and f32);
    the per-channel forwards against the fused forward bit for bit, their
    summed gradients against the fused gradient; `n_out` on the card
    against the CPU (f64); E, F, W on the card against the CPU, and with
    repulsion off against the roll engine (f64)."""
    data = water_box(rep)
    result = {}
    for dtype in (torch.float64, torch.float32):
        sim = make_sim(data, dtype, device)
        box = make_box(data, dtype, device)
        state = sim.init_state(data.positions, box)
        k = asn_inputs(sim, state.pos, box)
        errs = {}
        calls = asn_calls(k)
        full = asn_calls(k, compact_cols=False)
        calls.update({f"{name}_full_layout": full[name]
                      for name in ("radial_fwd_asn", "radial_bwd_asn")})
        for name, (kern, plain) in calls.items():
            got = kern()
            ref = plain()
            _sync(device)
            errs[name] = asn_compare(name.removesuffix("_full_layout"), k,
                                     got, ref)
            del got, ref
        del calls, full
        tag = str(dtype).replace("torch.", "")
        result[tag] = errs
        result[f"packed_edge_cases_{tag}"] = packed_edge_cases(k)
        result[f"zero_rows_{tag}"] = zero_row_checks(k)
        result[f"build_inv_empty_rows_{tag}"] = build_inv_empty_rows(k)
        # the packed kernels' worst error as a fraction of its limit
        result[f"packed_err_over_limit_{tag}"] = {
            name: max([errs[name]["worst_ratio"]] + [
                c[name]["worst_ratio"] for c in
                result[f"packed_edge_cases_{tag}"].values()])
            for name in ("packed_fwd", "packed_bwd")}
        limits = (1e-9, 1e-8) if dtype == torch.float64 else (None, None)
        result[f"backward_{tag}"] = asn_backward_checks(sim, state, k,
                                                        *limits)
        result[f"channels_vs_fused_{tag}"] = asn_channels_vs_fused(sim,
                                                                   state, k)
        if dtype == torch.float64:
            result["n_out_card_vs_cpu_f64"] = asn_n_out_vs_cpu(sim, state, k)
            result["efw_card_vs_cpu_f64"] = asn_efw_vs_cpu(sim, state, k,
                                                           data)
            result["norep_fw_vs_roll_f64"] = asn_fw_vs_roll(sim, state, data,
                                                            device)
        del k
        torch.cuda.empty_cache()
    emit({"phase": "asn_kernels", "atoms": data.n_atoms, **asn_sizing(sim),
          **result})


def asn_entry_points(sim, bins, a, n_out=None, pair_stage=None):
    """{name: fn(pos, box, plain, compact_cols=True) -> the differentiable
    outputs} of the three entry points at `sim`'s sizing and pair stage
    (or `pair_stage`)."""
    spec = sim.potential.spec
    head = (spec.aev, sim._roll_grid, bins, a)
    stage = pair_stage or sim.pair_stage

    def fused(pos, box, plain, compact_cols=True):
        return asn.aev_asn_fused(
            *head, pos, box, sim._sections, spec.angular_caps,
            tiers=sim._tiers, repulsion=spec.repulsion, n_out=n_out,
            plain=plain, pair_stage=stage)[:3]

    def radial(pos, box, plain, compact_cols=True):
        return asn.radial_aev_asn(
            *head, pos, box, sim._sections, repulsion=spec.repulsion,
            n_out=n_out, compact_cols=compact_cols, plain=plain)

    def angular(pos, box, plain, compact_cols=True):
        return asn.angular_aev_asn(
            *head, pos, box, sim._sections, spec.angular_caps,
            tiers=sim._tiers, n_out=n_out, compact_cols=compact_cols,
            plain=plain, pair_stage=stage)[:1]

    return {"fused": fused, "radial": radial, "angular": angular}


def _cotangents(outs, seed=4):
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    return [torch.randn(o.shape, generator=g, dtype=o.dtype, device=o.device)
            for o in outs]


def _grads(fn, pos0, box0, cots, plain=False, **kw):
    """(dpos, dh) of sum(outputs x cotangents) of an entry point."""
    pos = pos0.clone().requires_grad_(True)
    h = box0.h.clone().requires_grad_(True)
    out = fn(pos, Box(h=h, origin=box0.origin), plain, **kw)
    e = sum((o * c).sum() for o, c in zip(out, cots))
    return torch.autograd.grad(e, (pos, h))


def asn_backward_checks(sim, state, k, dpos_limit, dh_limit, names=None,
                        pair_stage=None):
    """dpos and dh of sum(outputs x seeded cotangents) through each entry
    point (the per-channel ones in both column layouts; `names`: these
    cases only) with the pair stage `pair_stage` (default: the sim's): two
    calls of the explicit backward (the kernels) must agree bit for bit;
    with limits given, they are held against autograd through the plain
    forwards."""
    fns = asn_entry_points(sim, k["bins"], k["a"], pair_stage=pair_stage)
    with torch.no_grad():
        fused_out = fns["fused"](state.pos, state.box, False)
    cots = _cotangents(fused_out)
    cases = {"fused": (fns["fused"], cots, {}),
             "radial": (fns["radial"], cots[:2], {}),
             "angular": (fns["angular"], cots[2:], {})}
    for name in ("radial", "angular"):
        with torch.no_grad():
            out = fns[name](state.pos, state.box, False, compact_cols=False)
        cases[f"{name}_full_layout"] = (fns[name], _cotangents(out, 5),
                                        {"compact_cols": False})
    lines = {}
    for name, (fn, cot, kw) in cases.items():
        if names is not None and name not in names:
            continue
        first = _grads(fn, state.pos, state.box, cot, **kw)
        second = _grads(fn, state.pos, state.box, cot, **kw)
        _sync(state.pos.device)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        line = {"two_calls_bit_for_bit": same}
        if not same:
            raise AssertionError(f"asn backward ({name}): two calls differ")
        if dpos_limit is not None:
            ref = _grads(fn, state.pos, state.box, cot, plain=True, **kw)
            line.update(dpos_err=float((first[0] - ref[0]).abs().max()),
                        dpos_limit=dpos_limit,
                        dh_err=float((first[1] - ref[1]).abs().max()),
                        dh_limit=dh_limit)
            if not (line["dpos_err"] <= dpos_limit
                    and line["dh_err"] <= dh_limit):
                raise AssertionError(f"asn backward ({name}) vs autograd: "
                                     f"{line}")
        lines[name] = line
    return lines


def channel_forwards_vs_fused(sim, k, pos, box):
    """(fused outputs, {output: equal}): the per-channel forwards in
    compact columns must equal the fused forward's outputs bit for bit,
    deficit included, and the full layout must hold the same columns at
    their torchani places among exact zeros."""
    spec = sim.potential.spec
    head = (spec.aev, sim._roll_grid, k["bins"], k["a"], pos, box,
            sim._sections)
    with torch.no_grad():
        fused = asn.aev_asn_fused(*head, spec.angular_caps, tiers=sim._tiers,
                                  repulsion=spec.repulsion)
        rad = asn.radial_aev_asn(*head, repulsion=spec.repulsion,
                                 compact_cols=True)
        ang = asn.angular_aev_asn(*head, spec.angular_caps, tiers=sim._tiers,
                                  compact_cols=True)
        rad_f = asn.radial_aev_asn(*head, repulsion=spec.repulsion)
        ang_f = asn.angular_aev_asn(*head, spec.angular_caps,
                                    tiers=sim._tiers)
    _sync(pos.device)
    equal = {"radial": torch.equal(rad[0], fused[0]),
             "erep": torch.equal(rad[1], fused[1]),
             "angular": torch.equal(ang[0], fused[2]),
             "deficit": torch.equal(ang[1], fused[3])}
    col0, srl = asn._radial_layout(spec.aev, sim._sections, False)
    chans = asn.present_channels(spec.aev, spec.angular_caps, sim._sections)

    def placed(full, compact, starts, width):
        """`full` holds `compact`'s column blocks at `starts` and exact
        zeros elsewhere."""
        absent = torch.ones(full.shape[1], dtype=torch.bool,
                            device=full.device)
        for c in starts:
            absent[c:c + width] = False
        return (torch.equal(torch.cat([full[:, c:c + width] for c in starts],
                                      1), compact)
                and not bool(full[:, absent].any()))

    equal["radial_full_layout"] = (
        rad_f[0].shape[1] == srl == spec.aev.radial_length
        and placed(rad_f[0], fused[0], col0, 16)
        and torch.equal(rad_f[1], fused[1]))
    equal["angular_full_layout"] = (
        ang_f[0].shape[1] == spec.aev.angular_length
        and placed(ang_f[0], fused[2], chans, 32)
        and torch.equal(ang_f[1], fused[3]))
    if not all(equal.values()):
        raise AssertionError(f"per-channel forward vs fused forward: {equal}")
    return fused, equal


def asn_channels_vs_fused(sim, state, k):
    """The per-channel forwards against the fused forward
    (`channel_forwards_vs_fused`); d(radial) + d(angular) is held
    against the fused gradient for the same cotangents (f64: dpos 1e-9,
    dh 1e-8; f32: TOL of the largest dpos entry and of the sum of the
    magnitudes of dh's terms)."""
    pos, box = state.pos, state.box
    fused, equal = channel_forwards_vs_fused(sim, k, pos, box)
    fns = asn_entry_points(sim, k["bins"], k["a"])
    # seed 0: the cotangents `asn_inputs` drew, so k["gt"] holds the terms
    # of this dh
    cots = _cotangents(fused[:3], seed=0)
    g_f = _grads(fns["fused"], pos, box, cots)
    g_r = _grads(fns["radial"], pos, box, cots[:2])
    g_a = _grads(fns["angular"], pos, box, cots[2:])
    line = {"forward_bit_for_bit": equal}
    atol, rtol = TOL[pos.dtype]
    for lab, i, lim64 in (("dpos", 0, 1e-9), ("dh", 1, 1e-8)):
        err = float((g_r[i] + g_a[i] - g_f[i]).abs().max())
        scale = (_chain_dh_scale(k, k["gt"]) if lab == "dh"
                 else float(g_f[i].abs().max()))
        limit = lim64 if pos.dtype == torch.float64 else atol + rtol * scale
        line[f"summed_{lab}_err"] = err
        line[f"summed_{lab}_limit"] = limit
        if not err <= limit:
            raise AssertionError(f"d(radial) + d(angular) vs fused: {line}")
    return line


def asn_n_out_vs_cpu(sim, state, k):
    """With `n_out` below the atom count: outputs and (dpos, dh) of the
    three entry points on the card (kernels) against the CPU (plain
    versions, explicit backward) on the same rebuild, f64."""
    n_out = k["n"] // 2
    bins_c, a_c = _to_cpu(k["bins"], k["a"])
    pos_c = state.pos.cpu()
    box_c = Box(h=state.box.h.cpu(), origin=state.box.origin.cpu())
    card = asn_entry_points(sim, k["bins"], k["a"], n_out)
    cpu = asn_entry_points(sim, bins_c, a_c, n_out)
    line = {"n_out": n_out, "atoms": k["n"]}
    for name in card:
        with torch.no_grad():
            out = card[name](state.pos, state.box, False)
            out_c = cpu[name](pos_c, box_c, False)
        cots = _cotangents(out)
        g = _grads(card[name], state.pos, state.box, cots)
        g_c = _grads(cpu[name], pos_c, box_c, [c.cpu() for c in cots])
        # rows beyond n_out carry no cotangent, yet every atom is a neighbor
        moved = int((g[0].abs().sum(1) > 0).sum())
        res = {"rows": int(out[0].shape[0]), "atoms_with_force": moved,
               "out_err": max(float((x.cpu() - y).abs().max())
                              for x, y in zip(out, out_c)),
               "out_limit": 1e-10,
               "dpos_err": float((g[0].cpu() - g_c[0]).abs().max()),
               "dpos_limit": 1e-9,
               "dh_err": float((g[1].cpu() - g_c[1]).abs().max()),
               "dh_limit": 1e-8}
        line[name] = res
        if not (res["rows"] == n_out and moved > n_out
                and res["out_err"] <= 1e-10 and res["dpos_err"] <= 1e-9
                and res["dh_err"] <= 1e-8):
            raise AssertionError(f"n_out on the card vs the CPU ({name}): "
                                 f"{res}")
    return line


def _efw_line(got, ref, same):
    line = {"same_capacities": same, "pe": float(ref[0]),
            "pe_rel_err": abs(float(got[0]) - float(ref[0]))
            / abs(float(ref[0])), "pe_limit": 1e-11,
            "force_err": float((got[1].cpu() - ref[1].cpu()).abs().max()),
            "force_limit": 1e-9,
            "virial_err": float((got[2].cpu() - ref[2].cpu()).abs().max()),
            "virial_limit": 1e-8}
    return line


def asn_efw_vs_cpu(sim, state, k, data):
    """E, F, W of the asn engine's force evaluation on the card (kernels)
    against the same evaluation on the CPU (plain versions, explicit
    backward), f64, on the same rebuild and pair stage."""
    got = sim._forces(state.pos, state.box, (k["bins"], k["a"]))
    sim_c = make_sim(data, torch.float64, "cpu", pair_stage=sim.pair_stage)
    box_c = make_box(data, torch.float64, "cpu")
    sim_c.init_state(data.positions, box_c)
    same = (asn_sizing(sim_c) == asn_sizing(sim)
            and bool(np.array_equal(sim_c.order, sim.order)))
    ref = sim_c._forces(state.pos.cpu(), box_c, _to_cpu(k["bins"], k["a"]))
    line = _efw_line(got, ref, same)
    if not (same and line["pe_rel_err"] <= 1e-11
            and line["force_err"] <= 1e-9 and line["virial_err"] <= 1e-8):
        raise AssertionError(f"asn E/F/W card vs CPU: {line}")
    return line


def asn_fw_vs_roll(sim, state, data, device):
    """With the repulsion term off: pe, F and W of the asn engine against
    the roll engine's at the same positions and weights, f64."""
    res = {}
    for engine in ("pallas_asn", "pallas_full"):
        s = make_sim(data, torch.float64, device, engine=engine,
                     repulsion=False)
        st = s.init_state(data.positions, make_box(data, torch.float64,
                                                   device))
        res[engine] = (st.pe, st.force, st.virial)
    line = _efw_line(res["pallas_asn"], res["pallas_full"], True)
    if not (line["pe_rel_err"] <= 1e-11 and line["force_err"] <= 1e-9
            and line["virial_err"] <= 1e-8):
        raise AssertionError(f"asn vs roll engine without repulsion: {line}")
    return line


def mlp_ms(sim, reps=10):
    """(forward ms, forward + backward ms) of the MLP ensemble on the asn
    path's compact AEV columns at this system's atom counts."""
    spec = sim.potential.spec
    col_idx = potmod.asn_col_idx(spec, sim._sections)
    aev = torch.rand((sim.n_atoms, len(col_idx)), dtype=sim.dtype,
                     device=sim.device, requires_grad=True)

    def fwd():
        return netmod.atomic_energies_sorted(
            spec.net, sim.potential.params, sim.species_counts, aev,
            col_idx=col_idx)

    def fwd_bwd():
        torch.autograd.grad(fwd().sum(), aev)

    with torch.no_grad():
        f_ms = time_ms(fwd, reps=reps)
    return f_ms, time_ms(fwd_bwd, reps=reps)


def laid_out_pairs(k):
    """(pair lanes of the tier layouts over every row handed to the packed
    calls, over the rows of real atoms only)."""
    part, total, real = k["part"], 0, 0
    for i, (cat, caps_t, _) in enumerate(k["packed"]):
        q = asn._packed_layout(k["spec"].aev, caps_t, k["a_offs"])[1]
        total += cat.shape[0] * q
        real += q * (k["n"] if part["tiers"] is None
                     else int(part["valid"][i].sum()))
    return total, real


def asn_kernel_row(name, k, kern, plain_fn, work, launches, reps,
                   ops=ASN_OPS, label=None):
    """(the kernel's row of the `kernels` line, named `label` or `name`,
    its timing entry): error against the plain version (raises beyond the
    limit), ms, the plain version's ms and the bound (`ops`: the operation
    count), on the inputs `k`."""
    err = asn_compare(name, k, kern(), plain_fn())
    torch.cuda.synchronize()
    b_ms, b_by = asn_bound(name, k, work, ops)
    ms = time_ms(kern, reps=reps, warm=1)
    plain_ms = time_ms(plain_fn, reps=2, warm=1)
    torch.cuda.empty_cache()
    timing = {**err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
              "bound_by": b_by}
    if two_term(name, ops):
        timing["fp32_ms"], timing["sfu_ms"] = two_term_ms(name, work, ops)
    row = {"name": label or name, "route": "cuda", "source": ASN_SOURCE,
           "replaces": asn.REPLACES[name].split()[0], "launches": launches,
           "max_abs_err": err["max_abs_err"],
           "err_over_limit": err["worst_ratio"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    return row, timing


def wing_integer_check(k, seed=7):
    """The wing kernel against its plain version on the rebuild's tables
    `k["a"]`, with integer-valued gt (|g| <= 64 on the live compact lanes,
    0 on the dead ones, as chain_sum leaves them): the float sums of such
    values are exact in any order, so any difference is a mapping error of
    the scatter over idx against the gather through inv. Raises unless the
    two are equal bit for bit."""
    idx, inv, gt = k["a"].idx, k["a"].inv, k["gt"]
    cap = idx.shape[1]
    g = torch.Generator(device=gt.device).manual_seed(seed)
    vals = torch.randint(-64, 65, gt.shape, generator=g,
                         device=gt.device).to(gt.dtype)
    live = (idx.to(torch.int32) < 27 * cap)[:, :, None, :]
    gi = torch.where(live, vals, 0.0).contiguous()
    got = asn.wing(gi, inv, idx)
    ref = asn.wing_plain(gi, inv)
    torch.cuda.synchronize()
    bits = torch.int32 if gt.dtype == torch.float32 else torch.int64
    n_diff = int((got.view(bits) != ref.view(bits)).sum())
    out = {"dtype": str(gt.dtype).replace("torch.", ""),
           "entries": ref.numel(), "bit_mismatches": n_diff,
           "max_abs": float(ref.abs().max()),
           "nonzero": int((ref != 0).sum())}
    if n_diff or not out["nonzero"]:
        raise AssertionError(f"wing on integer gt: {out}")
    return out


def phase_asn_timing(device, sim, state, launches, roll_sim, reps=10):
    """The asn path at the main path's final state (f32); returns the
    eight main-path kernels' rows. Launches per MD step: a step is one force
    evaluation, which launches step_fused once."""
    torch.cuda.empty_cache()
    dtype = torch.float32
    box = state.box
    # `Simulation` wraps positions at every rebuild; so does this phase
    pos = nbops.wrap_positions(state.pos, box)
    n = sim.n_atoms
    k = asn_inputs(sim, pos, box)
    ovf = float(k["a"].ovf)
    work = asn_work(k)
    rows, timing = [], {}
    calls = asn_calls(k)
    lanes_all, lanes_real = laid_out_pairs(k)
    for name in ASN_KERNELS:
        row, timing[name] = asn_kernel_row(name, k, *calls[name], work,
                                           launches[name], reps)
        timing[name]["launches_per_step"] = (launches[name]
                                             / launches["step_fused"])
        if name in ("packed_fwd", "packed_bwd"):
            # the pair lanes of the tier layouts against the filled pairs
            row.update(pair_lanes_laid_out=lanes_all,
                       pair_lanes_laid_out_real_rows=lanes_real,
                       filled_pairs=work["pairs"])
        rows.append(row)
    del calls
    wing_int = wing_integer_check(k)
    bins, a = k["bins"], k["a"]
    spec = sim.potential.spec
    a_state = (sim._roll_grid, bins, a, sim._sections, sim._tiers)
    del k
    torch.cuda.empty_cache()

    # three rounds of `reps` calls each, to show the spread
    rebuild_ms = [time_ms(lambda: sim._bins(pos, box), reps=reps)
                  for _ in range(3)]
    forward_ms = [time_ms(lambda: asn.aev_asn_fused(
        spec.aev, sim._roll_grid, bins, a, pos, box, sim._sections,
        spec.angular_caps, tiers=sim._tiers, repulsion=spec.repulsion),
        reps=reps) for _ in range(3)]
    force_ms = [time_ms(lambda: sim._forces(pos, box, (bins, a)), reps=reps)
                for _ in range(3)]
    mlp_f, mlp_fb = mlp_ms(sim, reps=reps)

    # the energies through the plain versions on the card
    e, deficit = potmod.atomic_energies_asn(sim.potential, sim.species, pos,
                                            box, a_state, sim.species_counts)
    e_p, _ = potmod.atomic_energies_asn(sim.potential, sim.species, pos, box,
                                        a_state, sim.species_counts,
                                        plain=True)
    atol, rtol = TOL[dtype]
    e_lim = atol + rtol * float(e_p.abs().max())
    e_err = float((e - e_p).abs().max())
    dmax = float(deficit.max())
    del e_p
    vs_roll = norep_vs_roll(sim, pos, box, a_state, roll_sim, device)
    emit({"phase": "asn_timing", "atoms": n, "dtype": "float32", "models": 1,
          "repulsion": True, **asn_sizing(sim), "work": work, "ovf": ovf,
          "ovf_sec": a.ovf_sec.tolist(), "deficit": deficit.tolist(),
          "rebuild_ms": rebuild_ms, "forward_ms": forward_ms,
          "force_eval_ms": force_ms, "mlp_forward_ms": mlp_f,
          "mlp_forward_backward_ms": mlp_fb,
          "energy": float(e.double().sum()),
          "energy_vs_plain": {"max_atom_err": e_err, "limit": e_lim},
          "norep_vs_roll": vs_roll, "wing_integer_check": wing_int,
          "kernels": timing})
    if not (ovf <= 0 and dmax <= 0):
        raise AssertionError(f"asn path: overflow {ovf}, deficit {dmax}")
    if not e_err <= e_lim:
        raise AssertionError(f"asn energies vs plain: {e_err} > {e_lim}")
    return rows


def _median3(fn, reps):
    """Three rounds of `reps` calls by CUDA events: (median ms, rounds)."""
    rounds = [time_ms(fn, reps=reps) for _ in range(3)]
    return float(np.median(rounds)), rounds


def phase_asn_channels(device, sim, state, reps=10):
    """The per-channel surface at the main path's final state and sizing
    (f32), after a fresh rebuild; returns the four per-channel kernels'
    rows. The launch counts are zeroed just before the entry points are
    driven and read just after; the four kernels' comparisons with their
    plain versions follow and are not counted."""
    torch.cuda.empty_cache()
    box = state.box
    pos = nbops.wrap_positions(state.pos, box)
    k = asn_inputs(sim, pos, box)
    work = asn_work(k)
    fns = asn_entry_points(sim, k["bins"], k["a"])

    asn.reset_counts()
    fused, equal = channel_forwards_vs_fused(sim, k, pos, box)
    finite = all(bool(torch.isfinite(x).all()) for x in fused[:3])
    ovf, dmax = float(k["a"].ovf), float(fused[3].max())
    cots = _cotangents(fused[:3], seed=0)  # as `asn_inputs` drew them
    cases = {"fused": (fns["fused"], cots, {}),
             "radial": (fns["radial"], cots[:2], {}),
             "angular": (fns["angular"], cots[2:], {})}
    del fused
    grads = {name: _grads(fn, pos, box, cot)
             for name, (fn, cot, _) in cases.items()}
    atol, rtol = TOL[pos.dtype]
    summed = {}
    for lab, i in (("dpos", 0), ("dh", 1)):
        ref = grads["fused"][i]
        scale = (_chain_dh_scale(k, k["gt"]) if lab == "dh"
                 else float(ref.abs().max()))
        summed[lab] = {
            "err": float((grads["radial"][i] + grads["angular"][i]
                          - ref).abs().max()),
            "limit": atol + rtol * scale}
    del grads

    # the full torchani layout, as a caller gets it by default
    for name in ("radial", "angular"):
        with torch.no_grad():
            out = fns[name](pos, box, False, compact_cols=False)
        cases[f"{name}_full_layout"] = (fns[name], _cotangents(out, 5),
                                        {"compact_cols": False})
        del out
    times = {}
    for name, (fn, cot, kw) in cases.items():
        def forward(fn=fn, kw=kw):
            with torch.no_grad():
                fn(pos, box, False, **kw)

        def forward_backward(fn=fn, cot=cot, kw=kw):
            _grads(fn, pos, box, cot, **kw)

        f_ms, f_rounds = _median3(forward, reps)
        fb_ms, fb_rounds = _median3(forward_backward, reps)
        times[name] = {"forward_ms": f_ms, "forward_rounds_ms": f_rounds,
                       "forward_backward_ms": fb_ms,
                       "forward_backward_rounds_ms": fb_rounds}
        torch.cuda.empty_cache()
    launches, plain = dict(asn.LAUNCHES), dict(asn.PLAIN_CALLS)
    del cases, cots

    rows, timing = [], {}
    calls = asn_calls(k)
    for name in CHANNEL_KERNELS:
        row, timing[name] = asn_kernel_row(name, k, *calls[name], work,
                                           launches[name], reps)
        rows.append(row)
    emit({"phase": "asn_channels", "atoms": sim.n_atoms, "dtype": "float32",
          "repulsion": True, **asn_sizing(sim), "work": work, "ovf": ovf,
          "deficit_max": dmax, "forward_equals_fused_bit_for_bit": equal,
          "summed_gradients_vs_fused": summed, "entry_points": times,
          "both_channels_over_fused": {
              key: (times["radial"][key] + times["angular"][key])
              / times["fused"][key]
              for key in ("forward_ms", "forward_backward_ms")},
          "launches": launches, "plain_calls": plain, "kernels": timing})
    if not finite:
        raise AssertionError("asn_channels: non-finite AEV or repulsion")
    if not (ovf <= 0 and dmax <= 0):
        raise AssertionError(f"asn_channels: overflow {ovf}, deficit {dmax}")
    if any(launches[name] == 0 for name in CHANNEL_KERNELS):
        raise AssertionError(f"asn_channels: a per-channel kernel was not "
                             f"launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"asn_channels: a plain version ran: {plain}")
    if any(v["err"] > v["limit"] for v in summed.values()):
        raise AssertionError("asn_channels: d(radial) + d(angular) vs the "
                             f"fused gradient: {summed}")
    return rows


def norep_vs_roll(sim, pos, box, a_state, roll_sim, device):
    """Per-atom energies of the asn path without the repulsion term
    against the roll engine's, at the same positions and weights: in f64,
    held to TOL (both sum the same terms in another order), and in f32,
    reported (its difference is that of two f32 summation orders through
    the MLP, not of the algorithms). The roll engine's bins are those of
    a rebuild at these positions."""
    species, counts = sim.species, sim.species_counts
    roll_bins = roll_sim._bins(pos, box)
    if int(roll_bins.count_max) > roll_sim._roll_grid.cap:
        raise AssertionError("roll bins overflow at the asn path's state")
    out = {}
    for dtype in (torch.float64, torch.float32):
        b = Box(h=box.h.to(dtype), origin=box.origin.to(dtype))
        e = {}
        for name, caps in (("asn", sim.potential.spec.angular_caps),
                           ("roll", roll_sim.potential.spec.angular_caps)):
            pot = zoo.ani2x(num_models=1, seed=1, dtype=dtype, device=device)
            pot = pot.with_spec(dataclasses.replace(pot.spec,
                                                    angular_caps=caps))
            if name == "asn":
                e[name], d = potmod.atomic_energies_asn(
                    pot, species, pos.to(dtype), b, a_state, counts)
            else:
                e[name], d = potmod.atomic_energies_roll(
                    pot, species, pos.to(dtype), b, roll_sim._roll_grid,
                    roll_bins, counts, radial_shell=roll_sim._roll_shell)
            if float(d.max()) > 0:
                raise AssertionError(f"{name} path {dtype}: deficit {d}")
        atol, rtol = TOL[dtype]
        out[str(dtype).replace("torch.", "")] = {
            "max_atom_err": float((e["asn"] - e["roll"]).abs().max()),
            "limit": atol + rtol * float(e["roll"].abs().max())}
        del e
    res = out["float64"]
    if not res["max_atom_err"] <= res["limit"]:
        raise AssertionError(f"asn vs roll energies (f64): {res}")
    return out


def profile_groups(kernels):
    """torch.profiler kernel-name groups: the asn kernels named, the box
    cotangent's reduce, matrix products, the fold's rolls."""
    return tuple(
        [(name, (f"asn_{name}_kernel",)) for name in kernels]
        + [("dh_reduce", ("dh_reduce_kernel",)),
           ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "ampere_",
                       "Kernel2")),
           ("roll_fold", ("roll",))])


def profile_chunk(sim, state, kernels, groups=None, chunk=CHUNK):
    """Where one asn MD step spends its time: one chunk on the host clock
    and one under torch.profiler. The idle share is 1 - (device busy time
    of the profiled chunk) / (host time of the unprofiled chunk): the
    profiler's own host overhead stretches the profiled chunk's wall time.
    A chunk that overflowed a capacity runs twice (regrow, then again), so
    both chunks are taken again until one runs without a regrow. Returns
    (state, the numbers)."""
    from torch.profiler import ProfilerActivity, profile

    regrows = 0
    for _ in range(4):
        before = sim.regrow_events
        t0 = time.perf_counter()
        state, _ = sim.run(state, chunk)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sim.run(state, chunk)
            torch.cuda.synchronize()
        if sim.regrow_events == before:
            break
        regrows += sim.regrow_events - before
    else:
        raise AssertionError("profile: every chunk regrew a capacity")
    busy, groups, top = device_time(prof, chunk,
                                    groups or profile_groups(kernels))
    return state, {"engine": sim.engine, "pair_stage": sim.pair_stage,
                   "steps": chunk, "regrows_skipped": regrows,
                   "unprofiled_ms_per_step": chunk_ms / chunk,
                   "device_busy_ms_per_step": busy,
                   "device_idle_share": 1.0 - busy * chunk / chunk_ms,
                   "device_ms_per_step_by_group": groups,
                   "top_kernels_ms_per_step": top}


def phase_profile(sim, state):
    """The main path's step from its final state (`profile_chunk`);
    returns its numbers."""
    _, line = profile_chunk(sim, state, ASN_KERNELS)
    emit({"phase": "profile", **line})
    return line


# ---------------------------------------------------------------------------
# The per-block pair stage (pair_stage "blocks" and "blocks_full")
# ---------------------------------------------------------------------------


def stage_launches(aev, tiers_rows, stage, seed=6):
    """{kernel: [(rows, arms, column cotangent [rows, 32]), ...]}: every
    per-block launch of one force evaluation of `stage` over the tiers'
    flat rows `tiers_rows` [(cat_t, caps_t, a_offs)], with a seeded
    cotangent for each block."""
    g = torch.Generator(device=tiers_rows[0][0].device).manual_seed(seed)
    out = {name: [] for name in BLOCK_KERNELS}
    for cat_t, caps_t, a_offs in tiers_rows:
        for kind, args in asn._stage_blocks(aev, caps_t, a_offs, stage):
            if kind == "zero":
                continue
            ga = torch.randn((cat_t.shape[0], 32), generator=g,
                             dtype=cat_t.dtype, device=cat_t.device)
            tri = "_tri" if kind == "tri" else ""
            out["block_fwd" + tri].append((cat_t, args, None))
            out["block_bwd" + tri].append((cat_t, args, ga))
    return out


def block_call(name, aev, launches, plain=False, accs=None):
    """One force evaluation's launches of kernel `name` (its plain version
    with `plain`): the forward's [rows, 32] columns, or the backward's slot
    sums added into `accs` (zeros where not given)."""
    if name.startswith("block_fwd"):
        fn = getattr(asn, name + ("_plain" if plain else ""))
        return [fn(c, aev, *args) for c, args, _ in launches]
    fn = getattr(asn, name + ("_plain" if plain else ""))
    accs = accs or [torch.zeros_like(c) for c, _, _ in launches]
    return [fn(c, ga, aev, *args, acc)
            for (c, args, ga), acc in zip(launches, accs)]


def block_compare(name, got, ref):
    """Errors of a per-block kernel against its plain version: TOL of the
    largest magnitude of each launch's output. Raises beyond it."""
    worst, max_err = 0.0, 0.0
    for x, y in zip(got, ref):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype} != "
                                 f"plain {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: non-finite output")
        atol, rtol = TOL[x.dtype]
        err = float((x - y).abs().max())
        worst = max(worst, err / (atol + rtol * float(y.abs().max())))
        max_err = max(max_err, err)
    if worst > 1.0:
        raise AssertionError(f"{name}: err {max_err}, {worst} x the limit")
    return {"max_abs_err": max_err, "worst_ratio": worst,
            "launches": len(got)}


def block_work(launches, rca, live_rows=None):
    """(bytes, pairs) the launches must move and evaluate: for each block,
    the real rows' slot fields of its arms read once and 32 columns
    written (forward), or the fields, the columns' cotangent and the arm
    slots' sums read and written (backward); its filled slot pairs, each
    unordered pair once (a full same-species block's two orders have the
    same terms: the kernels walk its triangle). `live_rows` [rows] bool
    per launch's rows: the real rows (all where None)."""
    nbytes = pairs = 0.0
    for i, (cat, args, ga) in enumerate(launches):
        f = cat.element_size()
        atot = cat.shape[1] // 5
        live = (torch.ones(cat.shape[0], dtype=torch.bool, device=cat.device)
                if live_rows is None else live_rows[i])
        n = int(live.sum())
        d = cat[:, 3 * atot:4 * atot]
        if len(args) == 2:  # the triangle
            off1, a1, off2, a2, same = *args, *args, True
        else:
            off1, a1, off2, a2, same = args
        c1 = (d[:, off1:off1 + a1] < rca + 1.0).sum(1)[live].double()
        c2 = (d[:, off2:off2 + a2] < rca + 1.0).sum(1)[live].double()
        if same:
            pairs += float((c1 * (c1 - 1) / 2).sum())
        else:
            pairs += float((c1 * c2).sum())
        slots = a1 if same else a1 + a2
        nbytes += n * f * ((5 * slots + 32) if ga is None
                           else (5 * slots + 32 + 10 * slots))
    return nbytes, pairs


def block_laid_out(launches, live_rows):
    """Slot pairs the launches' blocks lay out at the tiers' caps over their
    real rows (`live_rows`, as block_work): a1 (a1 - 1) / 2 for the
    triangle, a1 a2 across species, a1 (a1 - 1) for the full form; the
    walk the kernels took before they found each arm's live prefix."""
    total = 0
    for (cat, args, _), live in zip(launches, live_rows):
        if len(args) == 2:
            q = args[1] * (args[1] - 1) // 2
        else:
            q = args[1] * (args[1] - 1) if args[4] else args[1] * args[3]
        total += q * int(live.sum())
    return total


def fwd_parked_zeros(launches, outs, big):
    """The forward's rows whose block arms are parked whole (u = 0, d = big,
    fc = 0 in every slot) must hold exact zeros, kernel (`outs`) and plain
    alike; returns how many such rows the launches hold."""
    n = 0
    for (cat, args, _), out in zip(launches, outs):
        c = cat.view(cat.shape[0], 5, -1)
        parked = ((c[:, 0] == 0) & (c[:, 1] == 0) & (c[:, 2] == 0)
                  & (c[:, 3] == big) & (c[:, 4] == 0))
        arms = ((args[0], args[1]),) if len(args) == 2 else (
            (args[0], args[1]), (args[2], args[3]))
        whole = torch.ones(cat.shape[0], dtype=torch.bool, device=cat.device)
        for off, a in arms:
            whole &= parked[:, off:off + a].all(1)
        if bool((out[whole] != 0).any()):
            raise AssertionError("a per-block forward wrote a nonzero entry "
                                 "on a row whose arms are parked whole")
        n += int(whole.sum())
    return n


def block_fwd_checks(name, aev, launches):
    """A per-block forward against its plain version, twice bit for bit,
    and its rows parked whole exact zeros (counted)."""
    big = 2.0 * aev.angular_cutoff + 10.0
    got = block_call(name, aev, launches)
    again = block_call(name, aev, launches)
    ref = block_call(name, aev, launches, plain=True)
    torch.cuda.synchronize()
    if not all(same_bits((x,), (y,)) for x, y in zip(got, again)):
        raise AssertionError(f"{name}: two calls differ")
    res = block_compare(name, got, ref)
    res["two_calls_bit_for_bit"] = True
    res["parked_rows_zero"] = fwd_parked_zeros(launches, got, big)
    fwd_parked_zeros(launches, ref, big)
    return res


def block_bound(name, nbytes, pairs):
    ops = "packed_fwd" if "fwd" in name else "packed_bwd"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(two_term_ms(ops, {"pairs": pairs}))
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def parked_rows(cat, big, every=3):
    """A copy of the flat rows `cat` [rows, 5 atot] with rows 0, every,
    2 every, ... parked whole (u = 0, d = big, fc = 0 in every slot)."""
    out = cat.clone()
    v = out.view(cat.shape[0], 5, -1)[::every]
    v.zero_()
    v[:, 3] = big
    return out


def parked_arms(launches, big):
    """(arm rows with every slot parked, arm rows with a live slot and a
    parked one) over the backward launches [(cat, arms, ga)]."""
    whole = part = 0
    for cat, args, _ in launches:
        c = cat.view(cat.shape[0], 5, -1)
        parked = ((c[:, 0] == 0) & (c[:, 1] == 0) & (c[:, 2] == 0)
                  & (c[:, 3] == big) & (c[:, 4] == 0))
        arms = ((args[0], args[1]),) if len(args) == 2 else (
            (args[0], args[1]), (args[2], args[3]))
        for off, a in arms:
            idx = torch.arange(1, a + 1, device=cat.device)
            n_live = ((~parked[:, off:off + a]) * idx).amax(1)
            whole += int((n_live == 0).sum())
            part += int(((n_live > 0) & (n_live < a)).sum())
    return whole, part


def blocks_kernel_checks(aev, tiers_rows):
    """Each per-block kernel against its plain version on `tiers_rows`, in
    both same-species forms; each kernel twice, bit for bit (the backwards
    adding into nonzero buffers); the forwards' rows parked whole exact
    zeros. The launches must hold arm rows with every slot parked and arm
    rows partly parked (a live prefix, then parked slots): their counts
    are reported."""
    out = {}
    big = 2.0 * aev.angular_cutoff + 10.0
    for stage in ("blocks", "blocks_full"):
        launches = stage_launches(aev, tiers_rows, stage)
        whole, part = parked_arms(
            launches["block_bwd"] + launches["block_bwd_tri"], big)
        if not (whole and part):
            raise AssertionError(f"{stage}: parked arm rows {whole}, partly "
                                 f"parked {part}: a case is not covered")
        out[f"parked_arm_rows_{stage}"] = {"whole": whole, "partly": part}
        for name in BLOCK_KERNELS:
            if not launches[name]:
                continue
            if name.startswith("block_bwd"):
                g = torch.Generator(device=tiers_rows[0][0].device)
                g.manual_seed(8)
                base = [torch.randn(c.shape, generator=g, dtype=c.dtype,
                                    device=c.device)
                        for c, _, _ in launches[name]]
                got = block_call(name, aev, launches[name],
                                 accs=[b.clone() for b in base])
                again = block_call(name, aev, launches[name],
                                   accs=[b.clone() for b in base])
                ref = block_call(name, aev, launches[name], plain=True,
                                 accs=[b.clone() for b in base])
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                if not same:
                    raise AssertionError(f"{name} ({stage}): two calls "
                                         "differ")
                got = [x - b for x, b in zip(got, base)]
                ref = [x - b for x, b in zip(ref, base)]
            else:
                res = block_fwd_checks(name, aev, launches[name])
                if not res["parked_rows_zero"]:
                    raise AssertionError(f"{name} ({stage}): no row parked "
                                         "whole: a case is not covered")
                out[f"{name}_{stage}"] = res
                continue
            res = block_compare(name, got, ref)
            res["two_calls_bit_for_bit"] = same
            out[f"{name}_{stage}"] = res
            del got, ref
    return out


def stage_vs_packed(sim, k, pos, box):
    """Forward and (dpos, dh) of `aev_asn_fused` and `angular_aev_asn`
    (compact columns) through "blocks" and "blocks_full" against the
    packed stage on the same rebuild, f64: 1e-12 of the largest entry."""
    out = {}
    for name in ("fused", "angular"):
        ref = None
        for stage in ("packed", "blocks", "blocks_full"):
            fn = asn_entry_points(sim, k["bins"], k["a"],
                                  pair_stage=stage)[name]
            with torch.no_grad():
                fwd = fn(pos, box, False)
            cots = _cotangents(fwd, seed=9)
            res = list(fwd) + list(_grads(fn, pos, box, cots))
            if ref is None:
                ref = res
                continue
            errs = [float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(res, ref)]
            out[f"{name}_{stage}_rel_err"] = max(errs)
            if not max(errs) <= 1e-12:
                raise AssertionError(f"{name} {stage} vs packed: {errs}")
    return out


def phase_asn_blocks(device, rep=6):
    """The per-block stage at WATER30 x rep^3, sized by
    `Simulation(pair_stage="blocks")`, f64 and f32: the four kernels
    against their plain versions at the full caps, at tier caps (4 below)
    and on a copy of the rows with every third row parked whole, in both
    same-species forms, two calls of each backward bit for
    bit; the backwards of `angular_aev_asn` and `aev_asn_fused` with
    "blocks" and "blocks_full" against autograd through the plain
    forwards (f64); both stages against packed (f64); E, F, W with
    "blocks" on the card against the CPU (f64)."""
    data = water_box(rep)
    result = {}
    for dtype in (torch.float64, torch.float32):
        sim = make_sim(data, dtype, device, pair_stage="blocks")
        box = make_box(data, dtype, device)
        state = sim.init_state(data.positions, box)
        k = asn_inputs(sim, state.pos, box)
        spec = sim.potential.spec
        caps = spec.angular_caps
        a_offs = k["a_offs"]
        # the untiered flat rows of every atom, at the full and tier caps
        static = (spec.aev, tuple(sim._roll_grid.ncells), sim._sections,
                  caps, None, True, "blocks")
        _, (_, _, part) = asn._angular_forward(
            static, state.pos, box.h.contiguous(), k["bins"].inv,
            k["bins"].species_grid, k["bins"].cell, k["bins"].slot,
            k["a"].idx, asn._KERNELS)
        cat = part["cats"][0]
        caps_t = tuple(max(4, c - 4) if c else 0 for c in caps)
        tag = str(dtype).replace("torch.", "")
        parked = parked_rows(cat, 2.0 * spec.aev.angular_cutoff + 10.0)
        result[tag] = blocks_kernel_checks(
            spec.aev, [(cat, caps, a_offs), (cat, caps_t, a_offs),
                       (parked, caps, a_offs)])
        if dtype == torch.float64:
            for stage in ("blocks", "blocks_full"):
                result[f"backward_{stage}_f64"] = asn_backward_checks(
                    sim, state, k, 1e-9, 1e-8, pair_stage=stage,
                    names=("fused", "angular", "angular_full_layout"))
            result["vs_packed_f64"] = stage_vs_packed(sim, k, state.pos, box)
            result["efw_card_vs_cpu_f64"] = asn_efw_vs_cpu(sim, state, k,
                                                           data)
        del k, part, cat
        torch.cuda.empty_cache()
    emit({"phase": "asn_blocks", "atoms": data.n_atoms, **asn_sizing(sim),
          **result})


def phase_blocks_md(device, sim_asn, state_asn, warm_chunks=1,
                    timed_chunks=3, seed=1, reps=10):
    """The asn MD path with the per-block pair stage at 101,250 atoms from
    the main path's final positions and velocities, sized by itself; its
    launch counts zeroed just before and read just after; one chunk under
    torch.profiler; then each per-block kernel at the final state against
    its plain version, its time and its bound, and the force evaluation
    through each stage. Returns the kernels' rows."""
    data = water_box(15)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    torch.cuda.empty_cache()
    asn.reset_counts()
    sim = make_sim(data, torch.float32, device,
                   integrator=integrate.Langevin(temp=300.0, damp=100.0,
                                                 generator=gen),
                   rebuild_every=CHUNK, seed=seed, pair_stage="blocks")
    state = sim.init_state(sim_asn.positions_input_order(state_asn),
                           make_box(data, torch.float32, device),
                           vel=sim_asn.velocities_input_order(state_asn))
    sizing_init = asn_sizing(sim)
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)
    before = sim.regrow_events
    state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device)
    launches = {name: asn.LAUNCHES[name] for name in BLOCK_MD_KERNELS}
    others = {name: asn.LAUNCHES[name] for name in asn.LAUNCHES
              if name not in BLOCK_MD_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    line = {"phase": "blocks_md", "engine": sim.engine,
            "pair_stage": sim.pair_stage, "atoms": data.n_atoms,
            "dtype": "float32", "models": 1, "repulsion": True,
            **_md_numbers(sim, rows, chunk_ms),
            "sizing_at_init": sizing_init, "sizing": asn_sizing(sim),
            "regrow_kinds": dict(sim.regrow_kinds),
            "regrow_events_timed": sim.regrow_events - before,
            "launches": launches, "other_launches": others,
            "plain_calls": plain}
    _check_md("blocks_md", warm_rows + rows, state, launches, plain)
    if any(others.values()):
        raise AssertionError(f"blocks_md: a kernel off the path ran: "
                             f"{others}")
    state, line["profile"] = profile_chunk(sim, state, BLOCK_MD_KERNELS)

    # each kernel at the final state, after a fresh rebuild
    box = state.box
    pos = nbops.wrap_positions(state.pos, box)
    k = asn_inputs(sim, pos, box)
    part = k["part"]
    steps = launches["step_fused"]
    tiers = part["tiers"] or ((sim.potential.spec.angular_caps, None),)
    tiers_rows = [(cat_t, caps_t, k["a_offs"])
                  for (caps_t, _), cat_t in zip(tiers, part["cats"])]
    live = (part["valid"] if part["tiers"] else
            [torch.arange(part["cats"][0].shape[0], device=device) < k["n"]])
    live_of = {id(cat_t): lv for (cat_t, _, _), lv in zip(tiers_rows, live)}
    calls = stage_launches(sim.potential.spec.aev, tiers_rows, "blocks")
    rca = sim.potential.spec.aev.angular_cutoff
    rows_out, timing = [], {}
    for name in BLOCK_KERNELS:
        lau = calls[name]
        live_l = [live_of[id(c)] for c, _, _ in lau]
        accs = [torch.zeros_like(c) for c, _, _ in lau]
        if name.startswith("block_fwd"):
            # the tiers' pad rows are parked whole
            err = block_fwd_checks(name, sim.potential.spec.aev, lau)
        else:
            err = block_compare(name, block_call(
                name, sim.potential.spec.aev, lau, accs=None), block_call(
                    name, sim.potential.spec.aev, lau, plain=True))
        torch.cuda.synchronize()
        nbytes, pairs = block_work(lau, rca, live_l)
        b_ms, b_by = block_bound(name, nbytes, pairs)
        ms = time_ms(lambda: block_call(name, sim.potential.spec.aev, lau,
                                        accs=accs), reps=reps, warm=1)
        plain_ms = time_ms(lambda: block_call(name, sim.potential.spec.aev,
                                              lau, plain=True),
                           reps=2, warm=1)
        torch.cuda.empty_cache()
        timing[name] = {**err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bytes": nbytes, "filled_pairs": pairs,
                        "laid_out_pairs": block_laid_out(lau, live_l),
                        "launches_per_step": launches[name] / steps}
        rows_out.append({
            "name": name, "route": "cuda", "source": ASN_SOURCE,
            "replaces": asn.REPLACES[name].split()[0],
            "launches": launches[name], "max_abs_err": err["max_abs_err"],
            "err_over_limit": err["worst_ratio"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    line["kernels"] = timing
    line["force_eval_vs_packed"] = force_eval_by_stage(sim, pos, box, k)
    emit(line)
    return rows_out


def force_eval_by_stage(sim, pos, box, k, reps=10):
    """One force evaluation (`energy_forces_virial_asn`) at the same state,
    sizing and tiers through each pair stage: ms (CUDA events, three
    rounds of `reps`, the median) and the energies against packed's."""
    out, ref = {}, None
    for stage in ("packed", "blocks", "blocks_full"):
        a_state = (sim._roll_grid, k["bins"], k["a"], sim._sections,
                   sim._tiers, stage)

        def evaluate(a_state=a_state):
            return potmod.energy_forces_virial_asn(
                sim.potential, sim.species, pos, box, a_state,
                sim.species_counts)

        e, f, _, _ = evaluate()
        ms, rounds = _median3(evaluate, reps)
        out[stage] = {"ms": ms, "rounds_ms": rounds}
        if ref is None:
            ref = (e, f)
            continue
        atol, rtol = TOL[pos.dtype]
        out[stage]["pe_rel_err"] = float(abs(e - ref[0]) / abs(ref[0]))
        out[stage]["force_err_over_limit"] = float(
            (f - ref[1]).abs().max()) / (atol + rtol * float(
                ref[1].abs().max()))
        if not out[stage]["force_err_over_limit"] <= 1.0:
            raise AssertionError(f"blocks_md: {stage} forces vs packed: "
                                 f"{out[stage]}")
    return out


def phase_pair_stage(device, rows=100352, caps_h=16, caps_o=8, reps=10,
                     plain_rows=8192, seed=0):
    """The pair stage alone on synthetic flat rows (the counterpart of
    examples/benchmark/micro_pair_stage.py, at its defaults): f32, unit
    vectors from a normal draw, d uniform in (0.9, 3.4), fc in (0.1, 1),
    a cotangent from a normal draw, every slot live; forward and backward
    ms of packed, blocks and blocks_full (CUDA events, three rounds of
    `reps`, the median), the stages against packed, and each per-block
    kernel's ms, launches per call, plain ms on `plain_rows` rows and
    bound."""
    from lammps_ani_torch.models import aev as aevmod

    aev = aevmod.ani2x_aev_spec()
    caps = (caps_h, 0, 0, caps_o, 0, 0, 0)
    sections = ((0, 68), (3, 36))
    a_offs, atot = asn._a_offsets(sections, caps)
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32
    u = torch.randn((3, rows, atot), generator=g, dtype=dt, device=device)
    u = u / u.norm(dim=0)
    d = 0.9 + 2.5 * torch.rand((rows, atot), generator=g, dtype=dt,
                               device=device)
    fc = 0.1 + 0.9 * torch.rand((rows, atot), generator=g, dtype=dt,
                                device=device)
    cat = torch.cat([u[0], u[1], u[2], d, fc], 1).contiguous()
    ncols = 32 * len(asn.present_channels(aev, caps, sections))
    ga = torch.randn((rows, ncols), generator=g, dtype=dt, device=device)
    del u, d, fc
    line = {"phase": "pair_stage", "rows": rows, "caps": [caps_h, caps_o],
            "sections": [list(x) for x in sections], "dtype": "float32"}
    ref = None
    for stage in asn.PAIR_STAGES:
        def fwd(stage=stage):
            return asn._tier_fwd(asn._KERNELS, cat, aev, caps, a_offs, stage)

        def bwd(stage=stage):
            return asn._tier_bwd(asn._KERNELS, cat, ga, aev, caps, a_offs,
                                 stage)

        asn.reset_counts()
        out = [fwd(), bwd()]
        counts = {k: v for k, v in asn.LAUNCHES.items() if v}
        if ref is None:
            ref = out
        atol, rtol = TOL[dt]
        errs = [float((x - y).abs().max()) / (atol + rtol * float(
            y.abs().max())) for x, y in zip(out, ref)]
        if max(errs) > 1.0:
            raise AssertionError(f"pair_stage {stage} vs packed: {errs}")
        f_ms, f_rounds = _median3(fwd, reps)
        b_ms, b_rounds = _median3(bwd, reps)
        line[stage] = {"forward_ms": f_ms, "forward_rounds_ms": f_rounds,
                       "backward_ms": b_ms, "backward_rounds_ms": b_rounds,
                       "launches_per_call": counts,
                       "err_over_limit_vs_packed": errs}
        del out
    for stage in ("blocks", "blocks_full"):
        for key in ("forward_ms", "backward_ms"):
            line[f"{stage}_over_packed_{key}"] = (line[stage][key]
                                                  / line["packed"][key])
    kernels = {}
    for stage in ("blocks", "blocks_full"):
        calls = stage_launches(aev, [(cat, caps, a_offs)], stage)
        sliced = stage_launches(aev, [(cat[:plain_rows].contiguous(), caps,
                                       a_offs)], stage)
        for name in BLOCK_KERNELS:
            if not calls[name]:
                continue
            accs = [torch.zeros_like(c) for c, _, _ in calls[name]]
            nbytes, pairs = block_work(calls[name], aev.angular_cutoff)
            b_ms, b_by = block_bound(name, nbytes, pairs)
            kernels[f"{name}_{stage}"] = {
                "launches_per_call": len(calls[name]),
                "ms": time_ms(lambda: block_call(name, aev, calls[name],
                                                 accs=accs), reps=reps),
                "plain_ms_rows": plain_rows,
                "plain_ms": time_ms(lambda: block_call(
                    name, aev, sliced[name], plain=True), reps=2),
                "bound_ms": b_ms, "bound_by": b_by}
            torch.cuda.empty_cache()
    line["kernels"] = kernels
    emit(line)


# ---------------------------------------------------------------------------
# The mirror engine and its hybrids (plain PyTorch; the pallas hybrid's
# radial channel is the roll radial kernels')
# ---------------------------------------------------------------------------

MIRROR_ENGINES = ("mirror", "xla", "pallas")
# torch.profiler kernel-name groups of a mirror MD step (no kernel of the
# port's own: PyTorch's gathers, scatters, reductions, products, the rest)
MIRROR_GROUPS = (("gather_index", ("index", "gather", "Index")),
                 ("scatter", ("scatter",)),
                 ("reduce", ("reduce", "Reduce")),
                 ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma",
                             "ampere_", "Kernel2")),
                 ("elementwise", ("elementwise", "Elementwise")))


def _all_counts():
    return {"roll": dict(ar.LAUNCHES), "asn": dict(asn.LAUNCHES),
            "roll_plain": dict(ar.PLAIN_CALLS),
            "asn_plain": dict(asn.PLAIN_CALLS)}


def _reset_all_counts():
    ar.reset_counts()
    asn.reset_counts()
    pmv.reset_counts()
    pmg.reset_counts()


def phase_mirror(device, rep=6):
    """The mirror engine and the two hybrids at WATER30 x 6^3 (6,480
    atoms), f64: E, F, W at the start state on the card against the CPU
    (the mirror with ANI-2x + XTB repulsion, the hybrids without), the
    launch counts of each card evaluation (the pallas hybrid: radial_fwd
    and radial_bwd, no plain version; the mirror and the xla hybrid: no
    kernel), and the mirror's forces against pallas_asn's at the same
    positions. The ghost capacity holds the 48 A box's 8,448 periodic
    images within 7.1 A (they outnumber its atoms), and the rebuild at
    the compared state reports no overflow."""
    data = water_box(rep)
    line = {"phase": "mirror", "atoms": data.n_atoms, "dtype": "float64"}
    for engine in MIRROR_ENGINES:
        res = {}
        for dev in (device, "cpu"):
            _reset_all_counts()
            sim = make_sim(data, torch.float64, dev, engine=engine,
                           ghost_capacity=4 * data.n_atoms)
            st = sim.init_state(data.positions,
                                make_box(data, torch.float64, dev))
            _sync(dev)
            res[dev] = (sim, st, _all_counts())
            overflow = sim._chunk(st, 0)[3]
            if overflow:
                raise AssertionError(f"mirror: {engine} on {dev}: the "
                                     f"rebuild overflowed: {overflow}")
        (sk, stk, counts), (sp, stp, _) = res[device], res["cpu"]
        same = (sk.engine == sp.engine == engine
                and sk._k_max == sp._k_max and sk._ang_cap == sp._ang_cap
                and sk._roll_grid == sp._roll_grid
                and sk.potential.spec.angular_caps
                == sp.potential.spec.angular_caps)
        out = _efw_line((stk.pe, stk.force, stk.virial),
                        (stp.pe, stp.force, stp.virial), same)
        launched = {k: v for k, v in {**counts["roll"],
                                      **counts["asn"]}.items() if v}
        plain = {k: v for k, v in {**counts["roll_plain"],
                                   **counts["asn_plain"]}.items() if v}
        out.update(engine=sk.engine, k_max=sk._k_max, ang_cap=sk._ang_cap,
                   angular_caps=list(sk.potential.spec.angular_caps),
                   repulsion=sk.potential.spec.repulsion is not None,
                   roll_grid=None if sk._roll_grid is None else
                   [list(sk._roll_grid.ncells), sk._roll_grid.cap],
                   launches=launched, plain_calls=plain)
        line[engine] = out
        want = ({"radial_fwd", "radial_bwd"} if engine == "pallas" else set())
        if not (same and out["pe_rel_err"] <= 1e-11
                and out["force_err"] <= 1e-9 and out["virial_err"] <= 1e-8):
            raise AssertionError(f"mirror: {engine} card vs CPU: {out}")
        if set(launched) != want or plain:
            raise AssertionError(f"mirror: {engine} launched {launched}, "
                                 f"plain versions {plain}; expected {want}")
        if engine == "mirror":
            mirror_state = (sk, stk)
        del res
        torch.cuda.empty_cache()
    # the mirror against pallas_asn at the same positions (f64)
    sk, stk = mirror_state
    sa = make_sim(data, torch.float64, device)
    sta = sa.init_state(sk.positions_input_order(stk),
                        make_box(data, torch.float64, device))
    f_m = torch.as_tensor(sk.forces_input_order(stk))
    f_a = torch.as_tensor(sa.forces_input_order(sta))
    err = float((f_m - f_a).abs().max())
    lim = 1e-10 + 1e-10 * float(f_a.abs().max())
    line["mirror_vs_pallas_asn"] = {
        "pe_rel_err": abs(float(stk.pe) - float(sta.pe)) / abs(float(sta.pe)),
        "pe_limit": 1e-11, "force_err": err, "force_limit": lim,
        "virial_err": float((stk.virial - sta.virial).abs().max()),
        "virial_limit": 1e-8}
    emit(line)
    v = line["mirror_vs_pallas_asn"]
    if not (v["pe_rel_err"] <= 1e-11 and err <= lim
            and v["virial_err"] <= 1e-8):
        raise AssertionError(f"mirror vs pallas_asn: {v}")


def cli_sizing(data, skin=2.0, cutoff=5.1):
    """k_max and the cell capacity as the JAX CLI sizes them
    (lammps_ani_tpu/run.py:118-119) from the density."""
    rlist = cutoff + skin
    density = data.n_atoms / float(abs(np.linalg.det(data.box_h)))
    r8 = lambda x: -(-int(x) // 8) * 8
    return r8(4.19 * rlist ** 3 * density * 1.3 + 8), r8(
        rlist ** 3 * density * 2.0 + 4)


def asn_forces_at(sim_asn, pos_in, box):
    """The asn engine's (pe, forces in the caller's atom order) at given
    positions (caller order), after a fresh rebuild; raises if a capacity
    of that rebuild overflowed."""
    pos = torch.as_tensor(pos_in[sim_asn.order], dtype=box.h.dtype,
                          device=box.h.device)
    pos_w = nbops.wrap_positions(pos, box)
    bins = sim_asn._bins(pos_w, box)
    if (int(bins[0].count_max) > sim_asn._roll_grid.cap
            or float(bins[1].ovf) > 0):
        raise AssertionError("asn_forces_at: the asn rebuild overflowed")
    pe, f, _, deficit = sim_asn._forces(pos_w, box, bins)
    if float(deficit.max()) > 0:
        raise AssertionError(f"asn_forces_at: angular deficit {deficit}")
    return float(pe), f.detach().cpu().numpy()[sim_asn.inv_order]


def phase_mirror_md(device, sim_asn, state_asn, warm_chunks=1,
                    timed_chunks=3, seed=1):
    """The JAX CLI's defaults on the main path's model and tile: the
    mirror engine (`Simulation` with `cellroll=False`, its default),
    101,250 atoms, f32, ANI-2x + XTB repulsion, one model, the cell list
    with k_max and cell capacity sized as the CLI sizes them, ang_skin at
    its default, Langevin 300 K (damp 100 fs), dt 0.5 fs, a rebuild every
    12 steps, from the main path's final positions and velocities: 1 warm
    and 3 timed chunks, one chunk under torch.profiler, regrows by kind,
    peak memory, and one force evaluation's forces against pallas_asn's at
    the final state."""
    data = water_box(15)
    n = data.n_atoms
    k_max, cell_cap = cli_sizing(data)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    pot = zoo.ani2x(num_models=1, seed=seed, dtype=torch.float32,
                    device=device, repulsion=True)
    nbr = NeighborConfig(cutoff=5.1, skin=2.0, k_max=k_max,
                         ghost_capacity=max(2048, n), rebuild_every=CHUNK,
                         use_cell_list=n > 2000, cell_capacity=cell_cap)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    sim = Simulation(potential=pot, species=data.species,
                     masses=data.masses_by_type[data.species], nbr=nbr,
                     dt=0.5, dtype=torch.float32, device=device,
                     integrator=integrate.Langevin(temp=300.0, damp=100.0,
                                                   generator=gen))
    box = make_box(data, torch.float32, device)
    t0 = time.perf_counter()
    state = sim.init_state(sim_asn.positions_input_order(state_asn), box,
                           vel=sim_asn.velocities_input_order(state_asn))
    _sync(device)
    t_init = time.perf_counter() - t0
    sizing_init = {"k_max": sim._k_max, "ang_cap": sim._ang_cap,
                   "angular_caps": list(sim.potential.spec.angular_caps),
                   "cell_capacity": sim._grid and sim._grid.cell_capacity}
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)
    regrow_warm = dict(sim.regrow_kinds)
    before = sim.regrow_events
    state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device)
    counts = _all_counts()
    launched = {k: v for k, v in {**counts["roll"], **counts["asn"]}.items()
                if v}
    line = {"phase": "mirror_md", "engine": sim.engine, "atoms": n,
            "dtype": "float32", "models": 1, "repulsion": True,
            "dt_fs": sim.dt, **_md_numbers(sim, rows, chunk_ms),
            "init_state_s": t_init,
            "cli_sizing": {"k_max": k_max, "cell_capacity": cell_cap,
                           "ghost_capacity": max(2048, n)},
            "sizing_at_init": sizing_init,
            "sizing": {"k_max": sim._k_max, "ang_cap": sim._ang_cap,
                       "angular_caps": list(sim.potential.spec.angular_caps),
                       "cell_capacity": sim._grid and sim._grid.cell_capacity,
                       "ghost_capacity": sim.nbr.ghost_capacity},
            "regrow_kinds_warm": regrow_warm,
            "regrow_kinds": dict(sim.regrow_kinds),
            "regrow_events_timed": sim.regrow_events - before,
            "launches": launched,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _check_md("mirror_md", warm_rows + rows, state, {"mirror": 1}, {})
    if sim.engine != "mirror" or launched:
        raise AssertionError(f"mirror_md: engine {sim.engine}, kernels "
                             f"launched {launched}")
    state, line["profile"] = profile_chunk(sim, state, (),
                                           groups=MIRROR_GROUPS)
    # one force evaluation at the final state: mirror against pallas_asn
    pos_in = sim.positions_input_order(state)
    pe_a, f_a = asn_forces_at(sim_asn, pos_in, state.box)
    t0 = time.perf_counter()
    pe_m, f_m, _, _ = sim._forces(state.pos, state.box,
                                  (state.nbrs, state.bins))
    _sync(device)
    f_m = f_m.detach().cpu().numpy()[sim.inv_order]
    atol, rtol = 5e-6, 1e-4
    lim = atol + rtol * float(np.abs(f_a).max())
    line["forces_vs_pallas_asn"] = {
        "pe_mirror": float(pe_m), "pe_asn": pe_a,
        "pe_rel_err": abs(float(pe_m) - pe_a) / abs(pe_a),
        "force_err": float(np.abs(f_m - f_a).max()), "force_limit": lim,
        "max_abs_force": float(np.abs(f_a).max()),
        "mirror_eval_host_ms": (time.perf_counter() - t0) * 1e3}
    emit(line)
    if not line["forces_vs_pallas_asn"]["force_err"] <= lim:
        raise AssertionError(f"mirror_md: forces vs pallas_asn: "
                             f"{line['forces_vs_pallas_asn']}")


# ---------------------------------------------------------------------------
# The probes (lammps_ani_torch/probes, csrc/probes.cu)
# ---------------------------------------------------------------------------


def probe_compare(got, ref, exact=False):
    """Errors of a probe kernel against its plain version: NaN and inf in
    the same entries, the finite ones within 5e-6 + 1e-5 of the entry
    (f32 sums of non-negative terms in another order), or equal (the
    gathers)."""
    nan_ok = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
    inf_ok = bool(torch.equal(torch.isinf(got), torch.isinf(ref)))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    err = (got[fin] - ref[fin]).abs()
    worst = (float((err / (5e-6 + 1e-5 * ref[fin].abs())).max())
             if err.numel() else 0.0)
    out = {"max_abs_err": float(err.max()) if err.numel() else 0.0,
           "err_over_limit": worst, "nan_pattern_equal": nan_ok,
           "inf_pattern_equal": inf_ok,
           "non_finite": int((~torch.isfinite(ref)).sum())}
    if exact:
        out["equal"] = bool(torch.equal(got, ref))
        ok = out["equal"]
    else:
        ok = nan_ok and inf_ok and worst <= 1.0
    return out, ok


def column_err_over_limit(got, ref):
    """Per output column, the largest |got - ref| / (5e-6 + 1e-5 |ref|)
    over the entries finite in both (probe_compare's limit)."""
    fin = torch.isfinite(ref) & torch.isfinite(got)
    ratio = ((got - ref).abs() / (5e-6 + 1e-5 * ref.abs()))
    ratio = torch.where(fin, ratio, torch.zeros_like(ratio))
    return [float(v) for v in ratio.reshape(-1, ref.shape[-1]).amax(0)]


def phase_probes(device, reps=10):
    """The probes' own entry points on the card (the counterparts of
    examples/benchmark/micro_kernel_variants.py, micro_gather.py and
    micro_pieces.py at their main sizes), their launch counts zeroed
    just before and read just after; then each probe kernel and mode
    against its plain version, its ms, plain ms, library ms and bound, and
    the radial forward kernel (rows 22-23) on the probe grid. Returns the
    kernels' rows."""
    _reset_all_counts()
    variants = {st: pmv.run_variant(st, reps=reps, device=device)
                for st in pmv.STAGES}
    gathers = [pmg.run(*case, reps=reps, device=device)
               for case in pmg.CASES]
    s = pmp.setup(device=device)
    bare = pmp.bare_kernel(reps=reps, device=device, s=s)
    launches_v, launches_g = dict(pmv.LAUNCHES), dict(pmg.LAUNCHES)
    launches_r = ar.LAUNCHES["radial_fwd"]
    plain = {**pmv.PLAIN_CALLS, **pmg.PLAIN_CALLS,
             "radial_fwd": ar.PLAIN_CALLS["radial_fwd"]}
    if (any(v == 0 for v in {**launches_v, **launches_g}.values())
            or launches_r == 0 or any(plain.values())):
        raise AssertionError(f"probes: launches {launches_v} {launches_g} "
                             f"radial_fwd {launches_r}, plain {plain}")
    # the pieces of micro_pieces after the count (they launch radial_fwd
    # again inside radial_aev_roll)
    pieces = pmp.pieces(reps=reps, device=device, s=s)
    line = {"phase": "probes", "variants_main": pmv.MAIN,
            "variants_ms": {st: v["ms"] for st, v in variants.items()},
            "gather_ms": gathers, "bare_kernel": bare, "pieces_ms": pieces,
            "launches": {**launches_v, **launches_g,
                         "radial_fwd": launches_r}}
    rows, checks = [], {}
    args = pmv.make_inputs(**pmv.MAIN, seed=0, device=device)
    nc, cap, w = pmv.MAIN["nc"], pmv.MAIN["cap"], pmv.MAIN["w"]
    n_in = pmv.pairs_within(*args[:6])
    line["variants_pairs_within_cutoff"] = n_in
    for st in pmv.STAGES:
        got = pmv.radial_variant(st, *args)
        again = pmv.radial_variant(st, *args)
        ref = pmv.radial_variant_plain(st, *args)
        _sync(device)
        cols = pmv.WRITTEN[st]
        err, ok = probe_compare(got[..., :cols], ref[..., :cols])
        if not (ok and bool(torch.equal(got[..., cols:], ref[..., cols:]))):
            raise AssertionError(f"probes: variant {st}: {err}")
        if not same_bits((got,), (again,)):
            raise AssertionError(f"probes: variant {st}: two calls differ")
        col_ratio = column_err_over_limit(got[..., :cols], ref[..., :cols])
        del got, again, ref
        plain_ms = time_ms(
            lambda: pmv.radial_variant_plain(st, *args), reps=1)
        t_b = pmv.variant_bytes(st, nc, cap, w) / PEAK_BYTES * 1e3
        b_ms, b_by = t_b, "bytes"
        bounds = {}
        for fused in (True, False):
            ops = pmv.variant_ops(st, nc, cap, w, n_in, fused=fused)
            t_o = max(ops["fp32"] / PEAK_F32_INSTR,
                      ops["sfu"] / PEAK_SFU) * 1e3
            bounds[fused] = ((t_b, "bytes") if t_b >= t_o
                             else (t_o, "operations"))
            if fused:
                b_ms, b_by = bounds[fused]
                fp32_ms = ops["fp32"] / PEAK_F32_INSTR * 1e3
                sfu_ms = ops["sfu"] / PEAK_SFU * 1e3
        checks[st] = {**err, "two_calls_equal": True,
                      "column_err_over_limit": col_ratio,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_ms_unfused": bounds[False][0],
                      "fp32_ms": fp32_ms, "sfu_ms": sfu_ms}
        rows.append({
            "name": f"probe_radial_variant<{st}>", "route": "cuda",
            "source": PROBE_SOURCE, "replaces": pmv.REPLACES[st].split()[0],
            "launches": launches_v[st], "max_abs_err": err["max_abs_err"],
            "err_over_limit": err["err_over_limit"],
            "ms": variants[st]["ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_unfused": bounds[False][0], "library_ms": None})
    del args
    torch.cuda.empty_cache()
    for case, timed in zip(pmg.CASES, gathers):
        inp = pmg.make_inputs(*case, seed=0, device=device)
        sector_ms = pmg.compact_sector_bytes(inp) / PEAK_BYTES * 1e3
        for mode in pmg.MODES:
            x, idx = pmg._operands(mode, inp)
            got = pmg.compact(mode, x, idx, inp["k"])
            again = pmg.compact(mode, x, idx, inp["k"])
            # every entry written: the kernel into an output of NaN
            filled = pmg._compact_into(torch.full_like(got, float("nan")),
                                       mode, x, idx, inp["k"])
            ref = pmg.compact_plain(mode, x, idx, inp["k"])
            _sync(device)
            err, ok = probe_compare(got, ref, exact=True)
            if not ok:
                raise AssertionError(f"probes: compact {mode} {case}: {err}")
            if not same_bits((got, got), (again, filled)):
                raise AssertionError(f"probes: compact {mode} {case}: two "
                                     f"calls or the NaN-filled output "
                                     f"differ")
            del got, again, filled, ref
            plain_ms = time_ms(
                lambda: pmg.compact_plain(mode, x, idx, inp["k"]), reps=1)
            lib = pmg.library_call(mode, inp)
            lib_ms = (time_ms(lib, reps=reps) if lib is not None
                      else None)
            nbytes = pmg.compact_bytes(mode, inp)
            b_ms = nbytes / PEAK_BYTES * 1e3
            floors = {}
            if mode in ("gather1", "gather3", "onehot"):
                floors["sector_floor_ms"] = sector_ms
            if mode == "onehot":
                floors["strategy_floor_ms"] = (
                    2 * pmg.onehot_steps(inp) / PEAK_F32_INSTR * 1e3)
            checks[f"{mode}{list(case)}"] = {
                **err, "bytes": nbytes, "two_calls_equal": True,
                "nan_filled_equal": True, **floors}
            rows.append({
                "name": f"probe_compact<{mode}>{list(case)}",
                "route": "cuda", "source": PROBE_SOURCE,
                "replaces": pmg.REPLACES[mode].split()[0],
                "launches": launches_g[mode],
                "max_abs_err": err["max_abs_err"], "ms": timed[mode],
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
                **floors, "library_ms": lib_ms})
        del inp
        torch.cuda.empty_cache()
    # rows 22-23: the radial forward kernel on the probe grid (shell 1),
    # one timing for both JAX call sites
    k = {"pos_g": s["pos_g"], "sp_g": s["sp_g"], "h": s["h"],
         "ncells": s["grid"].ncells, "shell": 1, "spec": s["spec"],
         "present_r": s["present"], "present_a": s["present"],
         "caps": (0,) * 7}
    got = pmp.bare_call(s)()
    ref = ar.radial_fwd_plain(k["pos_g"], k["sp_g"], k["h"], k["ncells"], 1,
                              s["spec"], s["present"])
    _sync(device)
    err = compare("radial_fwd", k, got, ref)
    if err["worst_ratio"] > 1.0:
        raise AssertionError(f"probes: radial_fwd on the probe grid: {err}")
    del got, ref
    nan_filled = radial_fwd_every_entry(k)
    plain_ms = time_ms(lambda: ar.radial_fwd_plain(
        k["pos_g"], k["sp_g"], k["h"], k["ncells"], 1, s["spec"],
        s["present"]), reps=1)
    work = work_counts(k)
    b_ms, b_by = bound("radial_fwd", k, work)
    line["radial_fwd_probe_grid"] = {
        "ncells": list(k["ncells"]), "cap": s["grid"].cap, **err,
        "nan_filled_ratio": nan_filled, "work": work, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        **dict(zip(("fp32_ms", "sfu_ms"),
                   roll_two_term_ms("radial_fwd", work))),
        "layout_floor_ms": layout_floor_ms("radial_fwd", k)}
    rows.append({
        "name": "radial_fwd<probe grid>", "route": "cuda", "source": SOURCE,
        "replaces": "examples/benchmark/micro_kernel_variants.py:189, "
                    "examples/benchmark/micro_pieces.py:110",
        "launches": launches_r, "max_abs_err": err["max_abs_err"],
        "err_over_limit": err["worst_ratio"], "ms": bare["ms"],
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    line["checks"] = checks
    emit(line)
    return rows


# ---------------------------------------------------------------------------
# The nvt and npt ensembles (md/integrate.py NoseHoover, NoseHooverNPT,
# BerendsenBarostat) on the grid engines
# ---------------------------------------------------------------------------

NPT = dict(temp=300.0, tdamp=100.0, press=1.0, pdamp=500.0)  # water-NPT's


def ensemble(name):
    """Simulation keywords of the nvt (examples/water), npt
    (examples/water-NPT) and NVE + Berendsen ensembles."""
    if name == "nvt":
        return dict(integrator=integrate.NoseHoover(temp=300.0, tdamp=100.0))
    if name == "npt":
        return dict(integrator=integrate.NoseHooverNPT(**NPT))
    return dict(integrator=None,
                barostat=integrate.BerendsenBarostat(press=1.0, pdamp=100.0))


def scaled(data, scale):
    """`data` with its box and positions scaled about the box origin."""
    o = data.box_bounds[:, 0]
    return dataclasses.replace(
        data, positions=o + (data.positions - o) * scale,
        box_bounds=np.stack([o, o + (data.box_bounds[:, 1] - o) * scale], 1))


def grid_sim(data, device, engine, ens, rebuild_every=1):
    """An f64 Simulation of `engine` under ensemble `ens` at `data`'s start
    (velocities at 300 K from seed 1), and its state."""
    sim = make_sim(data, torch.float64, device, engine=engine,
                   rebuild_every=rebuild_every, **ensemble(ens))
    return sim, sim.init_state(data.positions,
                               make_box(data, torch.float64, device),
                               temp=300.0, seed=1)


def card_counts(engine):
    if engine == "pallas_asn":
        return ({k: asn.LAUNCHES[k] for k in ASN_KERNELS},
                dict(asn.PLAIN_CALLS))
    return dict(ar.LAUNCHES), dict(ar.PLAIN_CALLS)


def card_vs_cpu(device, data, engine, ens, chunks=2):
    """`chunks` chunks of one step of `engine` under `ens` on the card and
    the same run on the CPU: pe (rtol 1e-11), positions and box.h (1e-9 A)
    and the kernels the card's run launched (none of their plain
    versions)."""
    out = {}
    for dev in (device, "cpu"):
        sim, st = grid_sim(data, dev, engine, ens)
        if dev == device:
            _reset_all_counts()
        st, rows = sim.run(st, chunks, thermo_every=1)
        if dev == device:
            launches, plain = card_counts(engine)
            _check_md(f"nvt_npt {engine} {ens}", rows, st, launches, plain)
        out[dev] = (sim, st, rows)
    (sk, stk, rk), (sc, stc, _) = out[device], out["cpu"]
    if sk.engine != engine or sc.engine != engine:
        raise AssertionError(f"nvt_npt: {engine} ran as {sk.engine} / "
                             f"{sc.engine}")
    e_pe = abs(float(stk.pe) - float(stc.pe)) / abs(float(stc.pe))
    e_pos = float(np.abs(sk.positions_input_order(stk)
                         - sc.positions_input_order(stc)).max())
    e_h = float((stk.box.h.cpu() - stc.box.h).abs().max())
    line = {"pe_rel_err": e_pe, "pos_err": e_pos, "box_h_err": e_h,
            "vol_change": rk[-1]["vol"] / float(torch.det(
                make_box(data, torch.float64, "cpu").h)) - 1.0,
            "launches": launches}
    if not (e_pe <= 1e-11 and e_pos <= 1e-9 and e_h <= 1e-9):
        raise AssertionError(f"nvt_npt {engine} {ens}, card vs CPU: {line}")
    return line


def card_rederive(device, engine, rep=6, shrink=0.93):
    """A forced re-derive of the grid under NoseHooverNPT on the card, as
    tests/test_torch_npt_asn.py's: the box is first scaled so that its
    grid sits 6.5% above the engine's side, one chunk, then the state's box
    and positions are scaled by 0.93: the next chunk's `run` re-derives
    the grid to what the port's `_setup_grids` derives on the CPU from the
    same state (regrow_events rises by one for it, and by one for each
    capacity the 24% denser box outgrows, by kind) and launches the
    engine's kernels on the new grid."""
    data0 = water_box(rep)
    probe = make_sim(data0, torch.float64, "cpu", engine=engine)
    side = simmod.BAROSTAT_SLACK * probe._roll_side
    n = int(float(data0.box_h[0, 0]) // side)
    data = scaled(data0, n * 1.065 * probe._roll_side
                  / float(data0.box_h[0, 0]))
    sim, st = grid_sim(data, device, engine, "npt")
    st, _ = sim.run(st, 1)
    grid0 = (list(sim._roll_grid.ncells), sim._roll_grid.cap)
    box = Box(h=st.box.h * shrink, origin=st.box.origin)
    st = st.replace(box=box, pos=box.origin + (st.pos - box.origin) * shrink)
    cpu = make_sim(data, torch.float64, "cpu", engine=engine,
                   **ensemble("npt"))
    pos_in = sim.positions_input_order(st)
    cbox = box.to(device="cpu")
    cpu._spatial_sort(pos_in, cbox)
    cpu._setup_grids(torch.tensor(pos_in[cpu.order]), cbox)
    want = (list(cpu._roll_grid.ncells), cpu._roll_grid.cap, cpu._roll_shell)
    if sim._grids_valid(box.h.cpu().numpy()):
        raise AssertionError(f"nvt_npt {engine}: the box scaled by {shrink} "
                             f"still fits grid {grid0}")
    events, kinds = sim.regrow_events, dict(sim.regrow_kinds)
    _reset_all_counts()
    st, rows = sim.run(st, 1, thermo_every=1)
    launches, plain = card_counts(engine)
    grown = {k: v - kinds[k] for k, v in sim.regrow_kinds.items()
             if v != kinds[k]}
    line = {"atoms": data.n_atoms, "grid_before": grid0,
            "grid_after": (list(sim._roll_grid.ncells), sim._roll_grid.cap,
                           sim._roll_shell),
            "cpu_grid": want, "regrow_events": sim.regrow_events - events,
            "capacities_grown": grown, "launches": launches}
    _check_md(f"nvt_npt {engine} re-derive", rows, st, launches, plain)
    if (line["grid_after"][0] != want[0] or line["grid_after"][2] != want[2]
            or line["regrow_events"] != 1 + sum(grown.values())
            or sim.engine != engine):
        raise AssertionError(f"nvt_npt {engine} re-derive: {line}")
    if "roll" not in grown and line["grid_after"][1] != want[1]:
        raise AssertionError(f"nvt_npt {engine} re-derive: {line}")
    return line


def phase_nvt_npt(device, sim_asn, state_asn, warm_chunks=1,
                  timed_chunks=3):
    """The main path's model and state under NoseHooverNPT (water-NPT's
    settings, f32, cellroll=True, so pallas_asn), its counts zeroed just
    before and read just after; then the grid engines under NVT, NPT and
    Berendsen in f64 against the CPU, and a forced re-derive."""
    data = water_box(15)
    sim = make_sim(data, torch.float32, device, engine=None, cellroll=True,
                   **ensemble("npt"))
    if sim.engine != "pallas_asn":
        raise AssertionError(f"nvt_npt: engine {sim.engine}")
    state = sim.init_state(sim_asn.positions_input_order(state_asn),
                           make_box(data, torch.float32, device),
                           vel=sim_asn.velocities_input_order(state_asn))
    _reset_all_counts()
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)
    rows, chunk_ms, ends = [], [], []
    for _ in range(timed_chunks):
        t0 = time.perf_counter()
        state, r = sim.run(state, CHUNK, thermo_every=1)
        _sync(device)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        rows += r
        ends.append({"vol": r[-1]["vol"], "press": r[-1]["press"]})
    state, prof = profile_chunk(sim, state, ASN_KERNELS)
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    line = {"phase": "nvt_npt", "engine": sim.engine, "atoms": data.n_atoms,
            "dtype": "float32", "integrator": "NoseHooverNPT", **NPT,
            "dt_fs": sim.dt, **_md_numbers(sim, rows, chunk_ms),
            "chunk_ends": ends, "regrow_events": sim.regrow_events,
            "regrow_kinds": sim.regrow_kinds, "sizing": asn_sizing(sim),
            "omega": float(state.barostat.omega),
            "profile": {k: prof[k] for k in (
                "device_busy_ms_per_step", "device_idle_share",
                "unprofiled_ms_per_step", "device_ms_per_step_by_group")},
            "launches": launches, "plain_calls": plain,
            "roll_launches": dict(ar.LAUNCHES)}
    _check_md("nvt_npt", warm_rows + rows, state, launches, plain)
    small = water_box(6)
    full_cpu = scaled(water_box(2), 1.1)  # a 3^3 fine grid (see PERF.md)
    line["card_vs_cpu_f64"] = {
        engine: {"atoms": d.n_atoms,
                 **{ens: card_vs_cpu(device, d, engine, ens)
                    for ens in ("nvt", "npt", "berendsen")}}
        for engine, d in (("pallas_asn", small), ("pallas_full", full_cpu))}
    line["rederive_f64"] = {engine: card_rederive(device, engine)
                            for engine in ("pallas_asn", "pallas_full")}
    emit(line)


# ---------------------------------------------------------------------------
# ANI-1xnr (examples/combustion) and the CLI
# ---------------------------------------------------------------------------

COMBUSTION = os.path.join(ROOT, "examples", "combustion", "config.json")
CHUNK_CLI = 10  # the CLI's rebuild_every
# ANI-1xnr's count of the packed pair kernels: its zeta, 32, is an integer,
# so pair_powers takes zeta_pow's square and multiply, 5 squarings an angle
# section and no special function, where ANI-2x's split power takes 10
# fp32 and an lg2 and an ex2: packed_fwd 272 - 8 x 10 + 8 x 5 = 232 fp32
# and 21 - 16 = 5 sfu (the square root, 4 ex2), packed_bwd 306 - 40 = 266
# and 5.
ASN_OPS_1XNR = {**ASN_OPS, "packed_fwd": {"pairs": (232, 5)},
                "packed_bwd": {"pairs": (266, 5)}}

# the combustion system: examples/combustion's placement (species H 0, C 1,
# O 3; 160 CH4: 1,440 atoms, 0.25 g/cm^3, a 43.98 A box)
mixture = prepare_system.build


def make_sim_1xnr(data, dtype, device, engine="pallas_asn", integrator=None,
                  rebuild_every=CHUNK_CLI, seed=1, num_models=8):
    """A `Simulation` of ANI-1xnr (XTB repulsion always on), 8 models,
    weights drawn from `seed`, at the combustion config's dt (0.25 fs),
    sized as `make_sim` sizes the ANI-2x ones."""
    n = data.n_atoms
    nbr = NeighborConfig(cutoff=5.1, skin=2.0, k_max=128,
                         ghost_capacity=max(4096, n // 2),
                         use_cell_list=n > 4096, cell_capacity=32,
                         rebuild_every=rebuild_every)
    pot = zoo.ani1xnr(num_models=num_models, seed=seed, dtype=dtype,
                      device=device)
    return Simulation(potential=pot, species=data.species,
                      masses=data.masses_by_type[data.species], nbr=nbr,
                      dt=0.25, integrator=integrator, dtype=dtype,
                      device=device, engine=engine)


def identical(a, b):
    """Whether two sequences of tensors agree bit for bit."""
    return all(same_bits((x,), (y,)) if x.is_floating_point()
               else torch.equal(x, y) for x, y in zip(a, b))


def phase_ani1xnr_kernels(device, rep=2):
    """The main path's eight asn kernels against their plain versions at
    ANI-1xnr's constants (zeta 32 by the integer power, 4 species and 10
    pair blocks, Rcr 5.2 beside the repulsion's 5.1, eta_a 8, the AEV 384
    wide), 8 models, on the combustion mixture replicated rep^3 (11,520
    atoms), sized by `Simulation`, f64 and f32: asn_compare's limits, each
    worst error as a fraction of its limit, two calls of each bit for bit,
    the packed kernels' edge cases; then E, F, W of
    `energy_forces_virial_asn` on the card against the CPU, f64, on the
    1,440-atom mixture."""
    data = replicate(mixture(), rep, rep, rep)
    result = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        sim = make_sim_1xnr(data, dtype, device)
        box = make_box(data, dtype, device)
        state = sim.init_state(data.positions, box)
        if sim.engine != "pallas_asn":
            raise AssertionError(f"ani1xnr_kernels: engine {sim.engine}")
        k = asn_inputs(sim, state.pos, box)
        calls = asn_calls(k)
        errs, twice = {}, {}
        for name in ASN_KERNELS:
            kern, plain = calls[name]
            got, again, ref = kern(), kern(), plain()
            _sync(device)
            errs[name] = asn_compare(name, k, got, ref)
            twice[name] = identical(got, again)
            del got, again, ref
        if not all(twice.values()):
            raise AssertionError(f"ani1xnr_kernels {tag}: two calls differ: "
                                 f"{twice}")
        ip, _ = ar._angular_params(sim.potential.spec.aev, (), dtype)
        result[tag] = {
            "sizing": asn_sizing(sim), "zeta_int": ip[1],
            "pair_blocks": len(asn._packed_layout(
                sim.potential.spec.aev, sim.potential.spec.angular_caps,
                k["a_offs"])[0]),
            "errors": errs,
            "err_over_limit": {n: e["worst_ratio"] for n, e in errs.items()},
            "two_calls_bit_for_bit": twice,
            "packed_edge_cases": packed_edge_cases(k)}
        del k, calls
        torch.cuda.empty_cache()
    small = mixture()
    sim = make_sim_1xnr(small, torch.float64, device)
    state = sim.init_state(small.positions,
                           make_box(small, torch.float64, device))
    bins, a = sim._bins(state.pos, state.box)
    got = sim._forces(state.pos, state.box, (bins, a))
    sim_c = make_sim_1xnr(small, torch.float64, "cpu")
    box_c = make_box(small, torch.float64, "cpu")
    sim_c.init_state(small.positions, box_c)
    same = (asn_sizing(sim_c) == asn_sizing(sim)
            and bool(np.array_equal(sim_c.order, sim.order)))
    ref = sim_c._forces(state.pos.cpu(), box_c, _to_cpu(bins, a))
    efw = _efw_line(got, ref, same)
    emit({"phase": "ani1xnr_kernels", "atoms": data.n_atoms, "models": 8,
          **result, "efw_card_vs_cpu_f64": {"atoms": small.n_atoms,
                                            **efw}})
    if not (same and efw["pe_rel_err"] <= 1e-11 and efw["force_err"] <= 1e-9
            and efw["virial_err"] <= 1e-8):
        raise AssertionError(f"ani1xnr E/F/W card vs CPU: {efw}")


def phase_ani1xnr_md(device, rep=4, warm_chunks=1, timed_chunks=3, seed=1,
                     reps=10):
    """The combustion config's model and settings at a realistic size:
    the mixture replicated rep^3 (92,160 atoms), ANI-1xnr with 8 models in
    f32 on `pallas_asn`, NVT at 2500 K (tdamp 50 fs), dt 0.25 fs, a rebuild
    every 10 steps, velocities at 2500 K from `seed`; the counts zeroed
    just before and read just after: 1 warm and 3 timed chunks (ms/step on
    the host clock, ns/day), one chunk under torch.profiler (device busy,
    idle share, each kernel's device ms a step), the eight kernels'
    launches (all required, no plain version); then each kernel at the
    final state against its plain version, its ms, plain ms and bound
    (ASN_OPS_1XNR). Returns their rows, named `<kernel><ani1xnr>`, the
    simulation and its final state."""
    data = replicate(mixture(), rep, rep, rep)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = make_sim_1xnr(data, torch.float32, device,
                        integrator=integrate.NoseHoover(temp=2500.0,
                                                        tdamp=50.0))
    box = make_box(data, torch.float32, device)
    t0 = time.perf_counter()
    state = sim.init_state(data.positions, box, temp=2500.0, seed=seed)
    _sync(device)
    t_init = time.perf_counter() - t0
    _reset_all_counts()
    state, warm_rows = sim.run(state, warm_chunks * CHUNK_CLI,
                               thermo_every=1)
    for attempt in range(3):
        before = sim.regrow_events
        state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device,
                                           chunk=CHUNK_CLI)
        if sim.regrow_events == before:
            break
    state, prof = profile_chunk(sim, state, ASN_KERNELS, chunk=CHUNK_CLI)
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    _check_md("ani1xnr_md", warm_rows + rows, state, launches, plain)
    if any(ar.LAUNCHES.values()) or any(ar.PLAIN_CALLS.values()):
        raise AssertionError("ani1xnr_md: the asn engine ran a roll kernel")
    peak = torch.cuda.max_memory_allocated() / 1e9
    pos = nbops.wrap_positions(state.pos, state.box)
    k = asn_inputs(sim, pos, state.box)
    work = asn_work(k)
    calls = asn_calls(k)
    kern_rows, timing = [], {}
    by_group = prof["device_ms_per_step_by_group"]
    for name in ASN_KERNELS:
        row, timing[name] = asn_kernel_row(
            name, k, *calls[name], work, launches[name], reps,
            ops=ASN_OPS_1XNR, label=f"{name}<ani1xnr>")
        timing[name]["launches_per_step"] = (
            launches[name] / max(launches["step_fused"], 1))
        timing[name]["device_ms_per_step"] = by_group.get(name)
        kern_rows.append(row)
    del k, calls
    torch.cuda.empty_cache()
    emit({"phase": "ani1xnr_md", "engine": sim.engine,
          "atoms": data.n_atoms, "dtype": "float32", "models": 8,
          "integrator": "NoseHoover", "temp": 2500.0, "tdamp": 50.0,
          "dt_fs": sim.dt, "rebuild_every": CHUNK_CLI,
          **_md_numbers(sim, rows, chunk_ms), "init_state_s": t_init,
          "timed_windows_taken": attempt + 1,
          "profile": {key: prof[key] for key in (
              "device_busy_ms_per_step", "device_idle_share",
              "unprofiled_ms_per_step", "device_ms_per_step_by_group",
              "top_kernels_ms_per_step")},
          "sizing": asn_sizing(sim), "regrow_kinds": sim.regrow_kinds,
          "launches": launches, "plain_calls": plain, "work": work,
          "peak_mem_gb": peak, "kernels": timing})
    return kern_rows, sim, state


def phase_cli(device, steps=200, rep=4, pos_tol=1e-3):
    """The port's CLI (`lammps_ani_torch.run.main`) on the card, on the
    combustion config (examples/combustion/config.json: ANI-1xnr, 8 models,
    nvt at 2500 K, dt 0.25 fs, a DCD dump) and the 1,440-atom mixture,
    written by the port's `write_lammps_data` and read back by both
    parsers: `steps` (200) steps with a frame every steps / 4 (4 DCD
    frames, the last the final positions, which the restart written at
    the end holds; the thermo YAML to the last step); steps / 2 with a
    restart, then steps / 2 more from it (the final positions against the
    first call's: bit for bit, or the worst difference within `pos_tol`
    A); Langevin steps / 5 twice through a restart against 2 steps / 5
    straight (the generator's state carried, no warning);
    `minimize_first`; `replicate [rep] * 3` for steps / 10 (the cell list
    at 92,160 atoms), beside that data file parsed by the native and the
    Python parser. Each call's stdout is kept and its `Performance:` line
    reported."""
    import contextlib
    import io
    import tempfile
    import warnings

    from lammps_ani_torch import run as cli
    from lammps_ani_torch.io import dump as dumpio
    from lammps_ani_torch.io import lammps_data as ldio

    base = json.loads(open(COMBUSTION).read())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    data = mixture()
    path = os.path.join(tmp, "methane_oxygen.data")
    ldio.write_lammps_data(path, data)

    def parsed(p):
        t0 = time.perf_counter()
        py = ldio.read_lammps_data(p, fast=False)
        t1 = time.perf_counter()
        nat = ldio.read_lammps_data(p, fast=True)
        t2 = time.perf_counter()
        same = all(np.array_equal(getattr(py, f), getattr(nat, f))
                   for f in ("species", "positions", "masses_by_type",
                             "box_bounds", "tilt"))
        if not same:
            raise AssertionError(f"cli: the parsers disagree on {p}")
        return py, {"bytes": os.path.getsize(p), "python_s": t1 - t0,
                    "native_s": t2 - t1, "equal": same}

    back, parse_small = parsed(path)
    if not np.allclose(back.positions, data.positions, rtol=0, atol=1e-8):
        raise AssertionError("cli: the data file does not hold the system")
    line = {"phase": "cli", "atoms": data.n_atoms, "config": base,
            "parse": parse_small}

    def call(tag, **over):
        cfg = {**base, "data": path, "dump": None, "log": None,
               "device": device, **over}
        cfg_path = os.path.join(tmp, f"{tag}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        out = io.StringIO()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with contextlib.redirect_stdout(out):
                cli.main([cfg_path])
        text = out.getvalue().splitlines()
        perf = [x for x in text if x.startswith("# Performance:")]
        return {"wall_s": time.perf_counter() - t0,
                "performance": perf[-1] if perf else None,
                "warnings": [str(w.message) for w in caught],
                "minimize": [x for x in text if x.startswith("# minimize:")],
                "last_thermo": text[-2] if len(text) > 1 else None}

    def final_pos(restart_path):
        with np.load(restart_path) as z:
            return z["pos"].copy(), int(z["step"])

    def compare(a, b):
        return {"bit_for_bit": bool(np.array_equal(a, b)),
                "max_abs_diff": float(np.abs(a - b).max()),
                "tolerance": pos_tol}

    r = {n: os.path.join(tmp, f"{n}.npz") for n in (
        "full", "half", "resumed", "lang_a", "lang_b", "lang_straight")}
    dcd, yaml = os.path.join(tmp, "combustion.dcd"), os.path.join(
        tmp, "thermo.yaml")
    half, lang_n = steps // 2, steps // 5
    line["combustion"] = call("combustion", steps=steps,
                              dump_every=steps // 4, dump=dcd, log=yaml,
                              restart=r["full"])
    frames = dumpio.read_dcd(dcd)
    thermo = dumpio.read_thermo_yaml(yaml)
    pos_full, step_full = final_pos(r["full"])
    line["combustion"].update(
        frames=int(frames.shape[0]), thermo_steps=thermo["step"],
        last_frame_is_final=bool(np.array_equal(
            frames[-1], pos_full.astype(np.float32))),
        final_temp=thermo["temp"][-1])
    if not (frames.shape == (4, data.n_atoms, 3)
            and line["combustion"]["last_frame_is_final"]
            and thermo["step"][-1] == steps and step_full == steps):
        raise AssertionError(f"cli combustion: {line['combustion']}")

    line["restart_half"] = call("half", steps=half, restart=r["half"])
    line["resume_half"] = call("resumed", steps=half,
                               read_restart=r["half"], restart=r["resumed"])
    pos_res, step_res = final_pos(r["resumed"])
    line["resume_vs_straight"] = {"step": step_res,
                                  **compare(pos_res, pos_full)}

    lang = dict(ensemble="langevin")
    line["langevin"] = call("lang_a", steps=lang_n, restart=r["lang_a"],
                            **lang)
    line["langevin_resumed"] = call("lang_b", steps=lang_n,
                                    read_restart=r["lang_a"],
                                    restart=r["lang_b"], **lang)
    line["langevin_straight"] = call("lang_straight", steps=2 * lang_n,
                                     restart=r["lang_straight"], **lang)
    line["langevin_resume_vs_straight"] = compare(
        final_pos(r["lang_b"])[0], final_pos(r["lang_straight"])[0])

    line["minimize"] = call("minimize", steps=10, minimize_first=True)

    big = replicate(data, rep, rep, rep)
    big_path = os.path.join(tmp, "methane_oxygen_replicated.data")
    ldio.write_lammps_data(big_path, big)
    line["parse_replicated"] = {"atoms": big.n_atoms,
                                **parsed(big_path)[1]}
    line["replicate"] = {"atoms": big.n_atoms, **call(
        "replicate", steps=steps // 10, replicate=[rep] * 3)}
    emit(line)
    bad = [k for k in ("resume_vs_straight", "langevin_resume_vs_straight")
           if line[k]["max_abs_diff"] > pos_tol]
    if (bad or step_res != steps or line["langevin_resumed"]["warnings"]
            or not line["minimize"]["minimize"]
            or not line["replicate"]["performance"]):
        raise AssertionError(f"cli: {bad} {line}")
    return {"dcd": dcd, "data": path}


# ---------------------------------------------------------------------------
# RATTLE, collective-variable biases, profiling, fragments, the tile tool
# ---------------------------------------------------------------------------

# The reference's 30-atom water tile (its tests/water-0.8nm.data, as
# tests/fixtures.py holds it: 10 molecules in an 8 A cube about the
# origin). Its 20 O-H bonds are within the element-pair cutoffs; the
# synthetic weights have taken equil_water30.npz's molecules apart (one
# pair within them), so the constrained runs start from this tile.
WATER30_POS = np.array([
    [2.011, -3.116, 0.463], [2.86, -3.525, 0.294], [2.165, -2.181, 0.331],
    [2.386, -0.118, 2.278], [2.828, 0.165, 3.078], [2.781, 0.412, 1.585],
    [1.38, 1.855, 0.54], [1.942, 2.597, 0.317], [1.131, 2.008, 1.452],
    [-0.822, -3.413, 0.574], [0.133, -3.346, 0.568], [-1.118, -2.588, 0.958],
    [-0.555, 2.185, -2.095], [0.007, 2.852, -2.49], [-0.02, 1.803, -1.399],
    [2.07, -0.491, -0.665], [1.717, 0.373, -0.451], [1.38, -0.91, -1.18],
    [-2.282, 0.752, 0.227], [-2.603, 0.335, -0.573], [-2.91, 0.493, 0.901],
    [-0.21, -0.857, 1.541], [0.744, -0.78, 1.574], [-0.493, -0.112, 1.011],
    [-0.2, -1.356, -2.464], [-0.837, -0.898, -3.013], [-0.727, -1.942, -1.922],
    [-3.127, 2.221, -3.095], [-2.798, 2.675, -3.871], [-2.383, 2.202, -2.494],
])


def water30_box(rep: int) -> LammpsData:
    """The reference's water tile replicated rep^3 times."""
    tile = LammpsData(species=WATER30_SPECIES, positions=WATER30_POS,
                      masses_by_type=MASSES,
                      box_bounds=np.array([[-4.0, 4.0]] * 3),
                      tilt=np.zeros(3))
    return replicate(tile, rep, rep, rep)


def tile_bonds_replicated(rep):
    """The tile's bonds (`bond_pairs` on the CPU: its 20 O-H) in the
    replicated box's atom order: atom i of each copy with atom j of the
    copy that holds j's minimum image (`replicate`'s copy order)."""
    from lammps_ani_torch.analysis import fragments as frag

    tile = water30_box(1)
    h = tile.box_h
    copies = [(x, y, z) for x in range(rep) for y in range(rep)
              for z in range(rep)]
    index = {c: k for k, c in enumerate(copies)}
    n = tile.n_atoms
    out = []
    for i, j in frag.bond_pairs(tile.species, tile.positions, h,
                                device="cpu"):
        frac = (tile.positions[j] - tile.positions[i]) @ np.linalg.inv(h)
        s = -np.round(frac).astype(np.int64)
        for c in copies:
            a = index[c] * n + i
            b = index[tuple((np.asarray(c) + s) % rep)] * n + j
            out.append((min(a, b), max(a, b)))
    return sorted(out)


def _min_image_np(d, h):
    frac = d @ np.linalg.inv(h)
    return (frac - np.round(frac)) @ h


def _timed_chunks(sim, state, device, chunks, at_end):
    """`chunks` chunks of CHUNK steps (taken again, up to 3 times, where a
    capacity regrew in them), `at_end(state)` after each: (state, rows,
    ms/step by chunk, what at_end gave, windows taken)."""
    for attempt in range(3):
        before = sim.regrow_events
        rows, chunk_ms, ends = [], [], []
        for _ in range(chunks):
            t0 = time.perf_counter()
            state, r = sim.run(state, CHUNK, thermo_every=1)
            _sync(device)
            chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
            rows += r
            ends.append(at_end(state))
        if sim.regrow_events == before:
            break
    else:
        raise AssertionError("every timed window regrew a capacity: "
                             f"{sim.regrow_kinds}")
    return state, rows, chunk_ms, ends, attempt + 1


def constraint_stage(sim, state, reps=10):
    """One step's constraint stage alone (`project_positions` after a
    drift, then `project_velocities`) at `state`: its launches and
    device ms (torch.profiler) and its host ms (10 calls, synchronized)."""
    from torch.profiler import ProfilerActivity, profile

    r, dt, m = sim._rattle, sim.dt, sim.masses
    pos, vel, box = state.pos, state.vel, state.box
    pos_new = pos + dt * vel

    def stage():
        p, v = r.project_positions(pos_new, pos, vel, m, box, dt)
        return r.project_velocities(p, v, m, box)

    stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stage()
        torch.cuda.synchronize()
    kern = [ev for ev in device_events(prof)
            if not ev.name.startswith(("Memcpy", "Memset"))]
    t0 = time.perf_counter()
    for _ in range(reps):
        stage()
    torch.cuda.synchronize()
    return {"launches_per_step": len(kern),
            "device_ms_per_step": sum(ev.time_range.end
                                      - ev.time_range.start
                                      for ev in kern) / 1e3,
            "host_ms_per_step": (time.perf_counter() - t0) * 1e3 / reps,
            "iters": r.iters, "constraints": r.n_constraints}


def rattle_card_vs_cpu(device, rep=6, steps=12):
    """NVE with every O-H bond constrained on pallas_asn in f64 (the
    reference tile x rep^3, velocities at 300 K from seed 1): twice on the
    card (bit for bit), once on the CPU (positions within 1e-9 A), the
    bonds within 1e-8 A of their lengths; the eight kernels launched on the
    card, no plain version."""
    from lammps_ani_torch.analysis import fragments as frag
    from lammps_ani_torch.md import constraints as cons

    data = water30_box(rep)
    rat = cons.Rattle.from_bonds(
        frag.bond_pairs(data.species, data.positions, data.box_h,
                        device="cpu"), data.positions, data.box_h)
    runs = []
    for dev in (device, device, "cpu"):
        sim = make_sim(data, torch.float64, dev, constraints=rat)
        st = sim.init_state(data.positions,
                            make_box(data, torch.float64, dev), temp=300.0,
                            seed=1)
        if dev == device:
            _reset_all_counts()
        st, rows = sim.run(st, steps, thermo_every=1)
        if dev == device:
            launches, plain = card_counts("pallas_asn")
            _check_md("rattle_md f64", rows, st, launches, plain)
        runs.append((sim, st))
    (s1, a), (_, b), (sc, c) = runs
    pos = [s1.positions_input_order(a), s1.positions_input_order(b),
           sc.positions_input_order(c)]
    viol = float(rat.max_violation(torch.as_tensor(pos[0]),
                                   make_box(data, torch.float64, "cpu")))
    line = {"atoms": data.n_atoms, "constraints": rat.n_constraints,
            "steps": steps, "engine": s1.engine,
            "pos_err_vs_cpu": float(np.abs(pos[0] - pos[2]).max()),
            "max_violation": viol,
            "card_twice_same_bits": bool(
                torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)),
            "temp_last": rows[-1]["temp"], "launches": launches}
    if not (line["pos_err_vs_cpu"] <= 1e-9 and viol < 1e-8
            and line["card_twice_same_bits"] and s1.engine == "pallas_asn"):
        raise AssertionError(f"rattle_md f64: {line}")
    return line


def phase_rattle_md(device, rep=15, equil_chunks=12, warm_chunks=2,
                    timed_chunks=3, seed=1):
    """The main path's model, engine and settings (ANI-2x + XTB repulsion,
    one model, f32, cellroll=True, so pallas_asn; Langevin 300 K at damp
    100 fs, dt 0.5 fs, 12-step chunks) on the reference water tile x rep^3
    (101,250 atoms) with every O-H bond constrained: the bonds from
    `fragments.bond_pairs` on the card, equal to the tile's 20 replicated;
    12 chunks at damp 10 fs (the tile relaxes under the synthetic
    weights), then a fresh engine at that state, its counts zeroed just
    before its runs and read just after: 2 warm and 3 timed chunks
    (ms/step, `max_violation` at each chunk's end,
    below 1e-4 A, the temperature over the reduced dof), one chunk under
    torch.profiler (device busy, idle share), the constraint stage alone
    (launches, device and host ms a step); then `rattle_card_vs_cpu`."""
    from lammps_ani_torch.analysis import fragments as frag
    from lammps_ani_torch.md import constraints as cons

    data = water30_box(rep)
    box_h = data.box_h
    _sync(device)
    t0 = time.perf_counter()
    pairs = frag.bond_pairs(data.species, data.positions, box_h,
                            device=device)
    bonds_s = time.perf_counter() - t0
    if pairs != tile_bonds_replicated(rep):
        raise AssertionError(f"rattle_md: bond_pairs gave {len(pairs)} "
                             "pairs, not the tile's bonds replicated")
    rat = cons.Rattle.from_bonds(pairs, data.positions, box_h)
    gen = torch.Generator(device=device).manual_seed(seed)
    box = make_box(data, torch.float32, device)

    def constrained(damp):
        sim = make_sim(data, torch.float32, device, engine=None,
                       cellroll=True, constraints=rat,
                       integrator=integrate.Langevin(temp=300.0, damp=damp,
                                                     generator=gen))
        if sim.engine != "pallas_asn":
            raise AssertionError(f"rattle_md: engine {sim.engine}")
        return sim

    # the reference tile relaxes under the synthetic weights, and its
    # degrees drift while it does (the last tier's rows regrew nearly every
    # chunk): equil_chunks at damp 10 fs, then a fresh engine sized at the
    # relaxed state, as the main path starts from a relaxed tile
    sim_eq = constrained(10.0)
    state = sim_eq.init_state(data.positions, box, temp=300.0, seed=seed)
    state, equil_rows = sim_eq.run(state, equil_chunks * CHUNK,
                                   thermo_every=1)
    regrow_equil = dict(sim_eq.regrow_kinds)
    sim = constrained(100.0)
    state = sim.init_state(sim_eq.positions_input_order(state), box,
                           vel=sim_eq.velocities_input_order(state))
    del sim_eq
    _reset_all_counts()
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)

    def violation(st):
        pos = st.pos[sim._inv_order_t]
        return float(rat.max_violation(pos, st.box))

    state, rows, chunk_ms, viol, windows = _timed_chunks(
        sim, state, device, timed_chunks, violation)
    try:
        state, prof = profile_chunk(sim, state, ASN_KERNELS)
    except AssertionError as e:
        raise AssertionError(f"rattle_md: {e}: regrows {sim.regrow_kinds} "
                             f"(relaxing {regrow_equil}), sizing "
                             f"{asn_sizing(sim)}") from e
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    line = {"phase": "rattle_md", "engine": sim.engine,
            "atoms": data.n_atoms, "constraints": rat.n_constraints,
            "dof": sim.dof, "dtype": "float32", "dt_fs": sim.dt,
            "bond_pairs_s": bonds_s, **_md_numbers(sim, rows, chunk_ms),
            "max_violation_by_chunk": viol, "timed_windows_taken": windows,
            "equil": {"chunks": equil_chunks, "damp_fs": 10.0,
                      "temp_first": equil_rows[0]["temp"],
                      "temp_max": max(r["temp"] for r in equil_rows),
                      "temp_last": equil_rows[-1]["temp"]},
            "regrow_kinds_relaxing": regrow_equil,
            "regrow_kinds": sim.regrow_kinds, "sizing": asn_sizing(sim),
            "profile": {k: prof[k] for k in (
                "device_busy_ms_per_step", "device_idle_share",
                "unprofiled_ms_per_step", "device_ms_per_step_by_group")},
            "constraint_stage": constraint_stage(sim, state),
            "launches": launches, "plain_calls": plain}
    _check_md("rattle_md", warm_rows + rows, state, launches, plain)
    if not all(np.isfinite(r["temp"]) for r in equil_rows):
        raise AssertionError("rattle_md: non-finite temperature while the "
                             "tile relaxed")
    if max(viol) >= 1e-4:
        raise AssertionError(f"rattle_md: bonds off by {viol} A")
    line["card_vs_cpu_f64"] = rattle_card_vs_cpu(device)
    emit(line)


def cv_atoms(species, pos, box_h):
    """Atoms near the box's center for a distance, an angle and a
    dihedral: the O nearest the center, its two nearest H, the next
    nearest O and its nearest H; none straddles a face."""
    center = pos.min(0) + 0.5 * np.diag(box_h)
    o_idx = np.flatnonzero(species == 3)
    h_idx = np.flatnonzero(species == 0)
    o = o_idx[np.argsort(np.linalg.norm(pos[o_idx] - center, axis=1))]
    a, d = int(o[0]), int(o[1])
    hb = h_idx[np.argsort(np.linalg.norm(pos[h_idx] - pos[a], axis=1))]
    b, c = int(hb[0]), int(hb[1])
    e = int(h_idx[np.argmin(np.linalg.norm(pos[h_idx] - pos[d], axis=1))])
    atoms = {"distance": (a, b), "angle": (b, a, c), "dihedral": (b, a, d, e)}
    for idx in atoms.values():
        for x in idx[1:]:
            dd = pos[x] - pos[idx[0]]
            if not np.allclose(_min_image_np(dd, box_h), dd):
                raise AssertionError(f"cv atoms {idx} straddle a face")
    return atoms


BIAS_K = 40.0  # kcal/mol per CV unit squared
BIAS_OFFSETS = {"distance": 0.1, "angle": 0.1, "dihedral": 0.2}


def restraints(species, pos, box_h, k=BIAS_K):
    """`combine`-able restraints: one distance, one angle and one
    dihedral (`cv_atoms`), each centered BIAS_OFFSETS above its value at
    `pos`; and the CV functions by name."""
    from lammps_ani_torch.md import bias

    atoms = cv_atoms(species, pos, box_h)
    p = torch.as_tensor(pos)
    box = Box(h=torch.as_tensor(box_h), origin=torch.zeros(3,
                                                           dtype=p.dtype))
    cvs = {name: getattr(bias, f"{name}_cv")(*idx)
           for name, idx in atoms.items()}
    out = [bias.HarmonicBias(cv, k, float(cv(p, box)) + BIAS_OFFSETS[name],
                             2 * np.pi if name == "dihedral" else None)
           for name, cv in cvs.items()]
    return out, cvs, atoms


def bias_card_vs_cpu(device, rep=6, steps=12):
    """NVE with the three restraints on pallas_asn in f64 (the equilibrated
    tile x rep^3, velocities at 300 K from seed 1), card against CPU:
    positions within 1e-9 A; the eight kernels launched on the card."""
    from lammps_ani_torch.md import bias

    data = water_box(rep)
    biases, _, atoms = restraints(data.species, data.positions, data.box_h)
    runs = []
    for dev in (device, "cpu"):
        sim = make_sim(data, torch.float64, dev,
                       extra_force=bias.combine(biases))
        st = sim.init_state(data.positions,
                            make_box(data, torch.float64, dev), temp=300.0,
                            seed=1)
        if dev == device:
            _reset_all_counts()
        st, rows = sim.run(st, steps, thermo_every=1)
        if dev == device:
            launches, plain = card_counts("pallas_asn")
            _check_md("bias_md f64", rows, st, launches, plain)
        runs.append(sim.positions_input_order(st))
    line = {"atoms": data.n_atoms, "steps": steps, "cv_atoms": atoms,
            "pos_err_vs_cpu": float(np.abs(runs[0] - runs[1]).max()),
            "launches": launches}
    if not line["pos_err_vs_cpu"] <= 1e-9:
        raise AssertionError(f"bias_md f64: {line}")
    return line


def umbrella_windows(device, rep=6, steps=24, seed=3):
    """`run_windows` over 3 windows of `steps` steps (a distance CV, k 40,
    centers 0.1 A apart; f32 on pallas_asn, Langevin 300 K) on the
    equilibrated tile x rep^3, a sample every 4 steps, then the port's
    `wham` over the samples: the PMF's finite values."""
    from lammps_ani_torch.analysis import wham
    from lammps_ani_torch.md import bias

    data = water_box(rep)
    atoms = cv_atoms(data.species, data.positions, data.box_h)["distance"]
    d0 = float(np.linalg.norm(_min_image_np(
        data.positions[atoms[1]] - data.positions[atoms[0]], data.box_h)))
    centers = [d0 - 0.1, d0, d0 + 0.1]
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    samples = bias.run_windows(
        lambda extra: make_sim(
            data, torch.float32, device, extra_force=extra,
            integrator=integrate.Langevin(temp=300.0, damp=100.0,
                                          generator=gen)),
        data.positions, make_box(data, torch.float32, device), centers,
        BIAS_K, lambda: bias.distance_cv(*atoms), steps, sample_every=4,
        seed=seed)
    seconds = time.perf_counter() - t0
    x, pmf, f = wham.wham(samples, centers, k=BIAS_K, temp=300.0, n_bins=12)
    ok = np.isfinite(pmf)
    line = {"atoms": data.n_atoms, "windows": len(samples),
            "steps_per_window": steps, "cv_atoms": atoms,
            "centers": centers, "seconds": seconds,
            "samples": [s.tolist() for s in samples],
            "pmf_x": x[ok].tolist(), "pmf": pmf[ok].tolist(),
            "f": f.tolist()}
    if not (len(samples) == 3 and all(len(s) == steps // 4 and
                                      np.all(np.isfinite(s))
                                      for s in samples) and ok.sum() >= 2):
        raise AssertionError(f"bias_md windows: {line}")
    return line


def phase_bias_md(device, sim_asn, state_asn, main_line, prof_line,
                  warm_chunks=1, timed_chunks=3, seed=2):
    """The main path's model and final state (101,250 atoms, f32,
    pallas_asn, Langevin 300 K) with `bias.combine` of a distance, an
    angle and a dihedral restraint (k 40, each on atoms near the box's
    center, none across a face), the counts zeroed just before and read
    just after: 1 warm and 3 timed chunks (ms/step and device busy beside
    `main`'s, each CV at each chunk's end); then `bias_card_vs_cpu` and
    `umbrella_windows`."""
    from lammps_ani_torch.md import bias

    data = water_box(15)
    pos0 = sim_asn.positions_input_order(state_asn)
    box_h = state_asn.box.h.detach().cpu().numpy().astype(np.float64)
    biases, cvs, atoms = restraints(data.species, pos0, box_h)
    gen = torch.Generator(device=device).manual_seed(seed)
    sim = make_sim(data, torch.float32, device, engine=None, cellroll=True,
                   integrator=integrate.Langevin(temp=300.0, damp=100.0,
                                                 generator=gen),
                   extra_force=bias.combine(biases))
    if sim.engine != "pallas_asn":
        raise AssertionError(f"bias_md: engine {sim.engine}")
    state = sim.init_state(pos0, make_box(data, torch.float32, device),
                           vel=sim_asn.velocities_input_order(state_asn))
    _reset_all_counts()
    state, warm_rows = sim.run(state, warm_chunks * CHUNK, thermo_every=1)

    def cv_values(st):
        pos = st.pos[sim._inv_order_t]
        return {name: float(cv(pos, st.box)) for name, cv in cvs.items()}

    state, rows, chunk_ms, ends, windows = _timed_chunks(
        sim, state, device, timed_chunks, cv_values)
    state, prof = profile_chunk(sim, state, ASN_KERNELS)
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    md = _md_numbers(sim, rows, chunk_ms)
    line = {"phase": "bias_md", "engine": sim.engine, "atoms": data.n_atoms,
            "dtype": "float32", "k": BIAS_K, "cv_atoms": atoms,
            "centers": {name: b.center for name, b in zip(cvs, biases)},
            **md, "cv_by_chunk": ends, "timed_windows_taken": windows,
            "main_ms_per_step": main_line["ms_per_step"],
            "profile": {k: prof[k] for k in (
                "device_busy_ms_per_step", "device_idle_share",
                "unprofiled_ms_per_step")},
            "main_device_busy_ms_per_step":
                prof_line["device_busy_ms_per_step"],
            "launches": launches, "plain_calls": plain}
    _check_md("bias_md", warm_rows + rows, state, launches, plain)
    if not all(np.isfinite(v) for e in ends for v in e.values()):
        raise AssertionError(f"bias_md: CVs {ends}")
    line["card_vs_cpu_f64"] = bias_card_vs_cpu(device)
    line["windows_f32"] = umbrella_windows(device)
    emit(line)


def phase_trace(sim, state, top=10):
    """`profiling.trace` around one chunk of the main path, then
    `summarize_trace`: its top entries; the eight asn kernels named in it,
    the sum of its entries equal to the sum of the trace's device-kernel
    events, the "nn_forward" label present."""
    import glob
    import shutil
    import tempfile

    from lammps_ani_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            sim.run(state, CHUNK)
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary = profiling.summarize_trace(tmp, top=None)
        summarize_s = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(tmp, "*.pt.trace.json*"))
        tr = profiling.read_trace(path)
        trace_mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events_ms = sum(e["dur"] for e in profiling.kernel_events(tr)) / 1e3
    sum_ms = sum(ms for ms, _ in summary)
    named = {k: any(f"asn_{k}_kernel" in name for _, name in summary)
             for k in ASN_KERNELS}
    labels = sum(1 for e in tr["traceEvents"]
                 if e.get("name") == "nn_forward")
    line = {"phase": "trace", "steps": CHUNK, "trace_s": trace_s,
            "summarize_s": summarize_s, "trace_mb_gz": trace_mb,
            "kernels_named": len(summary), "sum_ms": sum_ms,
            "events_ms": events_ms, "kernel_ms_per_step": sum_ms / CHUNK,
            "asn_kernels_named": named, "nn_forward_ranges": labels,
            "top": [[ms, name[:120]] for ms, name in summary[:top]]}
    emit(line)
    if not (all(named.values()) and labels > 0
            and abs(sum_ms - events_ms) <= 1e-9 * max(events_ms, 1e-30)):
        raise AssertionError(f"trace: {line}")


def phase_fragments(device, sim_x, state_x, rep_small=2):
    """`bond_pairs` and `fragments` at `ani1xnr_md`'s final state (92,160
    atoms) on the card: seconds, pairs, fragments and formula counts; the
    card's pairs equal the CPU path's on the mixture x rep_small^3 (11,520
    atoms)."""
    from lammps_ani_torch.analysis import fragments as frag

    species = sim_x._species_in
    pos = sim_x.positions_input_order(state_x)
    h = state_x.box.h.detach().cpu().numpy().astype(np.float64)
    _sync(device)
    t0 = time.perf_counter()
    pairs = frag.bond_pairs(species, pos, h, device=device)
    pairs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels, formulas = frag.fragments(species, pos, h, device=device)
    fragments_s = time.perf_counter() - t0
    small = replicate(mixture(), rep_small, rep_small, rep_small)
    card = frag.bond_pairs(small.species, small.positions, small.box_h,
                           device=device)
    cpu = frag.bond_pairs(small.species, small.positions, small.box_h,
                          device="cpu")
    line = {"phase": "fragments", "atoms": len(species),
            "bond_pairs_s": pairs_s, "fragments_s": fragments_s,
            "pairs": len(pairs), "fragments": int(labels.max()) + 1,
            "formulas": dict(formulas.most_common(15)),
            "distinct_formulas": len(formulas),
            "small_atoms": small.n_atoms, "small_pairs": len(card),
            "small_card_equals_cpu": card == cpu}
    emit(line)
    if not (card == cpu and len(card) > 0
            and sum(formulas.values()) == line["fragments"]):
        raise AssertionError(f"fragments: {line}")


def phase_equilibrate_tile(device, legs=1, steps=100):
    """The port's tile tool on the card: the reference water tile written
    by the port's `write_lammps_data`, FIRE, then `legs` legs of `steps`
    Langevin steps, into the run's scratch directory: finite positions and
    velocities in the written .npz."""
    import shutil
    import tempfile

    from lammps_ani_torch.io.lammps_data import write_lammps_data
    from lammps_ani_torch.tools import equilibrate_tile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tile_")
    try:
        src, out = os.path.join(tmp, "water30.data"), os.path.join(
            tmp, "tile.npz")
        write_lammps_data(src, water30_box(1))
        log = []
        t0 = time.perf_counter()
        equilibrate_tile.equilibrate(src, out, legs=legs, steps=steps,
                                     device=device, log=log.append)
        seconds = time.perf_counter() - t0
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"phase": "equilibrate_tile", "legs": legs,
            "steps_per_leg": steps, "seconds": seconds, "log": log,
            "keys": sorted(got), "temp": float(got["temp"])}
    emit(line)
    if not (np.all(np.isfinite(got["positions"]))
            and np.all(np.isfinite(got["velocities"]))
            and got["positions"].shape == (30, 3)):
        raise AssertionError(f"equilibrate_tile: {line}")


# ---------------------------------------------------------------------------
# Domain decomposition (lammps_ani_torch/parallel/) on the in-process mesh
# ---------------------------------------------------------------------------

EARLY_EARTH = os.path.join(ROOT, "examples", "early_earth")


def domain_view(dsim, bins, a):
    """What `asn_inputs` reads of a `Simulation`, for one shard's rebuild
    of a `DomainSimulation`."""
    from types import SimpleNamespace

    return SimpleNamespace(
        potential=dsim.potential, _roll_grid=dsim._asn_grid.roll,
        _sections=dsim._sections, _tiers=dsim._tiers,
        pair_stage=dsim.pair_stage, kpad=dsim.kpad,
        nbr=SimpleNamespace(skin=dsim.rlist - dsim.potential.spec.cutoff),
        _bins=lambda pos, box: (bins, a))


def domain_shard_rebuild(dsim, state, shard=0):
    """(a fresh rebuild of `state`, one shard's extended positions)."""
    from lammps_ani_torch.parallel import domain as pdom

    payload, rb, _ = dsim._rebuild(state)
    pos_ext = pdom.halo_positions(dsim.mesh, dsim.dspec, payload["pos"],
                                  state.box, rb.plan)[shard].contiguous()
    return rb, pos_ext


def domain_shard_inputs(dsim, state, shard=0):
    """(the asn kernels' inputs of one shard at a fresh rebuild of `state`,
    the rebuild, that shard's extended positions): AEV rows for the owned
    slots only (n_aev), `n` the binned atoms."""
    rb, pos_ext = domain_shard_rebuild(dsim, state, shard)
    k = asn_inputs(domain_view(dsim, rb.bins[shard], rb.asn[shard]), pos_ext,
                   state.box, n_out=dsim.dspec.n_cap)
    k["n_aev"] = k["n"]
    k["n"] = int(rb.valid_ext[shard].sum())
    return k, rb, pos_ext


def brick_dh_zero(dsim, rb, pos_ext, box, shard=0, seed=5):
    """Whether the fused op's box cotangent on one shard's brick bins is
    exactly 0 for seeded cotangents (every wrapped window lane is an empty
    pad bin)."""
    spec = dsim.potential.spec
    h = box.h.detach().clone().requires_grad_(True)
    outs = asn.aev_asn_fused(
        spec.aev, dsim._asn_grid.roll, rb.bins[shard], rb.asn[shard],
        pos_ext, Box(h=h, origin=box.origin), dsim._sections,
        spec.angular_caps, tiers=dsim._tiers, repulsion=spec.repulsion,
        n_out=dsim.dspec.n_cap, pair_stage=dsim.pair_stage)[:3]
    g = torch.Generator(device=pos_ext.device).manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g, dtype=o.dtype,
                                device=o.device)).sum() for o in outs)
    (dh,) = torch.autograd.grad(loss, h)
    return int(torch.count_nonzero(dh)) == 0


def domain_f64_checks(device, rep=4, skin=1.0):
    """The reference tile x rep^3 (1,920 atoms, a 32 A cube), ANI-1xnr (one
    model, seed 1), f64 on the card: `DomainSimulation` (pallas_asn, the
    kernels on brick bins) on (1,1,1) and (2,2,2) with the packed stage and
    on (2,2,2) with "blocks", each evaluated at the input state (a rebuild,
    no step), against the single-device asn `Simulation` on the card: E/F/W
    at pe rtol 1e-11, F 1e-9, W 1e-8; a second evaluation bit for bit; the
    box cotangent on shard 0's bins exactly 0."""
    from lammps_ani_torch.parallel import domain as pdom
    from lammps_ani_torch.parallel.sim import DomainSimulation

    data = water30_box(rep)
    n = data.n_atoms
    masses = data.masses_by_type[data.species]
    pot = zoo.ani1xnr(num_models=1, seed=1, dtype=torch.float64,
                      device=device)
    box = make_box(data, torch.float64, device)
    sim = Simulation(potential=pot, species=data.species, masses=masses,
                     nbr=NeighborConfig(cutoff=5.1, skin=skin, k_max=128,
                                        ghost_capacity=8192,
                                        rebuild_every=10),
                     dt=0.25, dtype=torch.float64, device=device,
                     engine="pallas_asn")
    st = sim.init_state(data.positions, box)
    if sim.engine != "pallas_asn":
        raise AssertionError(f"domain f64: single-device engine {sim.engine}")
    f_ref = sim.forces_input_order(st)
    out = {"atoms": n, "single_device_pe": float(st.pe)}
    for mesh, stage in (((1, 1, 1), None), ((2, 2, 2), None),
                        ((2, 2, 2), "blocks")):
        rlist = max(5.1, pot.spec.cutoff) + skin
        dsim = DomainSimulation(
            pot, pdom.auto_domain_spec(n, data.box_h, mesh, rlist,
                                       k_max=128),
            cutoff=5.1, skin=skin, dt=0.25, dtype=torch.float64,
            device=device, engine="pallas_asn", pair_stage=stage)
        d0 = dsim.init_state(data.species, masses, data.positions, box)
        if dsim.engine != "pallas_asn":
            raise AssertionError(f"domain f64 {mesh}: engine {dsim.engine}")
        a, b = dsim.evaluate(d0), dsim.evaluate(d0)
        f = dsim.gather(a, "force")
        line = {"pe_rel_err": abs(float(a.pe) - float(st.pe))
                / abs(float(st.pe)),
                "force_err": float(np.abs(f - f_ref).max()),
                "virial_err": float((a.virial - st.virial).abs().max()),
                "two_evaluations_bit_for_bit": identical(
                    (a.force, a.pe, a.virial), (b.force, b.pe, b.virial)),
                "sizing": dsim.sizing()}
        rb, pos_ext = domain_shard_rebuild(dsim, d0)
        line["dh_exactly_zero"] = brick_dh_zero(dsim, rb, pos_ext, d0.box)
        out[f"{''.join(map(str, mesh))}_{stage or 'packed'}"] = line
        if not (line["pe_rel_err"] <= 1e-11 and line["force_err"] <= 1e-9
                and line["virial_err"] <= 1e-8
                and line["two_evaluations_bit_for_bit"]
                and line["dh_exactly_zero"]):
            raise AssertionError(f"domain f64 {mesh} {stage}: {line}")
    torch.cuda.empty_cache()
    return out


def domain_single_device(device, pot, restart, cfg, ref, fire_steps=100,
                         timed_chunks=3, seed=1):
    """The same system on the single-device pallas_asn `Simulation` (the
    config's settings, the restart's state): its E and F at the restart
    against the sharded engine's (`ref`: pe and forces in input order; f32:
    pe rtol 1e-5, F 5e-6 + 1e-4 max|F|); then FIRE for `fire_steps` steps
    (the restart was made under other weights: under these it heats from
    300 K to about 4,700 K in one chunk and rebuilds every 2.5 steps, not
    every 10), and velocities at 300 K drawn from `seed`; from that relaxed
    start, ms/step over 1 warm and 3 timed chunks (rebuilds counted by
    build_inv's launches) and one chunk under torch.profiler. Returns (the
    line, the relaxed positions and the velocities, in input order)."""
    from lammps_ani_torch.md.minimize import minimize

    with np.load(restart) as z:
        z = {key: z[key] for key in z.files}
    n = len(z["species"])
    every = int(cfg["rebuild_every"])
    nbr = NeighborConfig(cutoff=float(cfg["cutoff"]), skin=float(cfg["skin"]),
                         k_max=128, ghost_capacity=max(4096, n // 2),
                         use_cell_list=True, cell_capacity=32,
                         rebuild_every=every)

    def make():
        sim = Simulation(potential=pot, species=z["species"],
                         masses=z["mass"], nbr=nbr, dt=float(cfg["dt"]),
                         dtype=torch.float32, device=device,
                         engine="pallas_asn",
                         integrator=integrate.NoseHoover(
                             temp=float(cfg["stages"][0][0]),
                             tdamp=float(cfg["tdamp"])))
        if sim.engine != "pallas_asn":
            raise AssertionError(f"domain single device: engine {sim.engine}")
        return sim

    box = Box(h=torch.tensor(z["box_h"], device=device),
              origin=torch.tensor(z["box_origin"], device=device))
    sim = make()
    state = sim.init_state(z["pos"], box, vel=z["vel"])
    f = sim.forces_input_order(state)
    scale = float(np.abs(ref[1]).max())
    efw = {"pe_single": float(state.pe), "pe_domain": ref[0],
           "pe_rel_err": abs(float(state.pe) - ref[0]) / abs(ref[0]),
           "force_err": float(np.abs(f - ref[1]).max()),
           "force_limit": 5e-6 + 1e-4 * scale, "max_abs_force": scale}
    if not (efw["pe_rel_err"] <= 1e-5
            and efw["force_err"] <= efw["force_limit"]):
        raise AssertionError(f"domain: single device against sharded: {efw}")
    _sync(device)
    t0 = time.perf_counter()
    state, fire = minimize(sim, state, max_steps=fire_steps, ftol=1e-4)
    _sync(device)
    fire.update(seconds=time.perf_counter() - t0, fmax_at_restart=scale)
    pos = sim.positions_input_order(state)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    vel = integrate.create_velocities(
        gen, torch.as_tensor(z["mass"], dtype=torch.float64),
        float(cfg["stages"][0][0]), 3 * n - 3).numpy()
    sim = make()
    state = sim.init_state(pos, box, vel=vel)
    state, _ = sim.run(state, every)
    rebuilds = asn.LAUNCHES["build_inv"]
    state, rows, chunk_ms = _run_timed(sim, state, timed_chunks, device,
                                       chunk=every)
    rebuilds = asn.LAUNCHES["build_inv"] - rebuilds
    state, prof = profile_chunk(sim, state, ASN_KERNELS, chunk=every)
    line = {"efw_at_restart": efw, "fire": fire, "sizing": asn_sizing(sim),
            **_md_numbers(sim, rows, chunk_ms),
            "rebuilds_in_timed_chunks": rebuilds,
            "profile": {key: prof[key] for key in (
                "device_busy_ms_per_step", "device_idle_share",
                "unprofiled_ms_per_step")}}
    del sim, state
    torch.cuda.empty_cache()
    return line, pos, vel


def phase_domain(device, timed_chunks=3, reps=10):
    """Domain decomposition on the in-process mesh (`DomainSimulation`):
    `domain_f64_checks`; then examples/early_earth/config_50k.json at full
    ANI-1xnr width (one model as the config says, weights from seed 1),
    f32, mesh (2, 2, 2), capacities from `auto_domain_spec` at rlist
    max(cutoff, Rcr) + skin = 6.2 A, NoseHoover 300 K (tdamp 50 fs), dt 0.25
    fs, a rebuild every 10 steps, from `load_restart` of the JAX engine's
    restart early_earth_50k.stage0.npz (49,000 atoms): the engine must be
    pallas_asn; E and F there against the single-device engine, which then
    relaxes the restart with FIRE (`domain_single_device`: the restart was
    made under other weights) and is timed from the relaxed start; the
    sharded engine starts from the same positions and velocities: 1 warm
    chunk; two chunks from the same state bit for bit;
    the counts zeroed just before and read just after 3 timed chunks
    (ms/step on the host clock, ns/day, every gid once after each chunk,
    the eight asn kernels launched, no plain version and no roll kernel
    run; the rebuilds, from build_inv's launches); one chunk under
    torch.profiler (device busy, idle share); then each asn kernel on
    shard 0's brick bins at the final state against its plain version
    (rows `<kernel><domain>` of the kernels line) and the box cotangent
    there exactly 0. The phase's seconds, the build excluded. Returns
    (the kernels' rows, the relaxed start: species, masses, positions,
    velocities, box and config)."""
    from lammps_ani_torch.parallel import domain as pdom
    from lammps_ani_torch.parallel.sim import DomainSimulation

    t_phase = time.perf_counter()
    f64 = domain_f64_checks(device)
    with open(os.path.join(EARLY_EARTH, "config_50k.json")) as fh:
        cfg = json.load(fh)
    restart = os.path.join(EARLY_EARTH, cfg["restart_prefix"] + "0.npz")
    with np.load(restart) as z:
        box_h, n = z["box_h"], len(z["species"])
    every = int(cfg["rebuild_every"])
    pot = zoo.ani1xnr(num_models=int(cfg["num_models"]), seed=1,
                      dtype=torch.float32, device=device)
    rlist = max(float(cfg["cutoff"]), pot.spec.cutoff) + float(cfg["skin"])
    dspec = pdom.auto_domain_spec(n, box_h, tuple(cfg["mesh_shape"]), rlist,
                                  k_max=int(cfg["k_max"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dsim = DomainSimulation(
        pot, dspec, cutoff=float(cfg["cutoff"]), skin=float(cfg["skin"]),
        rebuild_every=every, dt=float(cfg["dt"]), dtype=torch.float32,
        device=device, integrator=integrate.NoseHoover(
            temp=float(cfg["stages"][0][0]), tdamp=float(cfg["tdamp"])))
    t0 = time.perf_counter()
    state = dsim.load_restart(restart)
    _sync(device)
    t_setup = time.perf_counter() - t0
    if dsim.engine != "pallas_asn":
        raise AssertionError(f"domain: engine {dsim.engine}")
    sizing_init = dsim.sizing()
    at_restart = dsim.evaluate(state)
    ref = (float(at_restart.pe), dsim.gather(at_restart, "force"))
    loaded = {"atoms": dsim.n_global, "step": state.step,
              "pe": ref[0], "max_abs_force": float(np.abs(ref[1]).max())}
    del at_restart
    single, pos, vel = domain_single_device(device, pot, restart, cfg, ref)
    with np.load(restart) as z:
        start = {"species": z["species"], "mass": z["mass"], "pos": pos,
                 "vel": vel, "box_h": z["box_h"],
                 "box_origin": z["box_origin"], "cfg": cfg}
    state = dsim.init_state(start["species"], start["mass"], pos, state.box,
                            vel=vel)
    state, warm_rows = dsim.run(state, every, thermo_every=1)
    for attempt in range(3):
        before = dsim.regrow_events
        a, _ = dsim.run(state, every)
        b, _ = dsim.run(state, every)
        if dsim.regrow_events == before:
            break
        state = b
    same = identical((a.pos, a.vel, a.force, a.pe, a.virial, a.gid),
                     (b.pos, b.vel, b.force, b.pe, b.virial, b.gid))
    state = a
    del b
    _reset_all_counts()
    rows, chunk_ms, gids_once = [], [], []
    regrows_before = dsim.regrow_events
    for _ in range(timed_chunks):
        t0 = time.perf_counter()
        state, r = dsim.run(state, every, thermo_every=1)
        _sync(device)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / every)
        rows += r
        gid = state.gid.cpu().numpy()
        gids_once.append(bool(np.array_equal(np.sort(gid[gid >= 0]),
                                             np.arange(n))))
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    roll = {k: v for k, v in ar.LAUNCHES.items() if v}
    regrows_timed = dsim.regrow_events - regrows_before
    _check_md("domain", warm_rows + rows, state, launches, plain)
    state, prof = profile_chunk(dsim, state, ASN_KERNELS, chunk=every)
    peak = torch.cuda.max_memory_allocated() / 1e9
    k, rb, pos_ext = domain_shard_inputs(dsim, state)
    dh_zero = brick_dh_zero(dsim, rb, pos_ext, state.box)
    work = asn_work(k)
    calls = asn_calls(k)
    kern_rows, timing = [], {}
    steps = len(rows)
    for name in ASN_KERNELS:
        row, timing[name] = asn_kernel_row(
            name, k, *calls[name], work, launches[name], reps,
            ops=ASN_OPS_1XNR, label=f"{name}<domain>")
        timing[name]["launches_per_step"] = launches[name] / steps
        kern_rows.append(row)
    del k, calls
    torch.cuda.empty_cache()
    line = {"phase": "domain",
            "config": "examples/early_earth/config_50k.json",
            "restart": "examples/early_earth/early_earth_50k.stage0.npz",
            "engine": dsim.engine, "atoms": n,
            "mesh_shape": list(dspec.mesh_shape), "dtype": "float32",
            "models": int(cfg["num_models"]), "rlist": dsim.rlist,
            "dt_fs": dsim.dt, "rebuild_every": every,
            **_md_numbers(dsim, rows, chunk_ms),
            "rebuilds_in_timed_chunks": (launches["build_inv"]
                                         / dspec.n_shards),
            "loaded_restart": loaded, "start": "FIRE from the restart, "
            "velocities at 300 K (domain_single_device)",
            "setup_s": t_setup, "sizing_at_restart": sizing_init,
            "sizing": dsim.sizing(), "regrow_kinds": dsim.regrow_kinds,
            "regrows_in_timed_chunks": regrows_timed,
            "two_chunks_bit_for_bit": same,
            "determinism_pairs_taken": attempt + 1,
            "gids_once_by_chunk": gids_once,
            "profile": {key: prof[key] for key in (
                "device_busy_ms_per_step", "device_idle_share",
                "unprofiled_ms_per_step", "device_ms_per_step_by_group",
                "top_kernels_ms_per_step")},
            "launches": launches, "plain_calls": plain,
            "launches_per_step": {k_: v / steps for k_, v in launches.items()},
            "peak_mem_gb": peak, "single_device": single,
            "shard0": {"atoms_binned": rb.valid_ext[0].sum().item(),
                       "owned": rb.valid[0].sum().item(), "work": work,
                       "dh_exactly_zero": dh_zero},
            "kernels": timing, "f64": f64,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if not (same and all(gids_once) and dh_zero and not roll):
        raise AssertionError(
            f"domain: bit for bit {same}, gids {gids_once}, dh zero "
            f"{dh_zero}, roll kernels {roll}")
    return kern_rows, start


# ---------------------------------------------------------------------------
# The process-group backend (parallel/comm.ProcessGroupMesh) on one card
# ---------------------------------------------------------------------------


def _nccl_group(tmp, device):
    """A one-rank NCCL process group in this process (a FileStore under
    `tmp`); no fallback to gloo."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=timedelta(seconds=300), device_id=device)


def distributed_f64(device, mesh, rep=4, steps=12):
    """The reference tile x rep^3 (1,920 atoms), ANI-1xnr (one model, seed
    1), f64, pallas_asn on mesh (1,1,1): the process group against
    `LocalMesh` on the card from the same state (velocities at 300 K, seed
    1): E, F and W of one evaluation and the positions and velocities
    after `steps` NVE steps, bit for bit."""
    from lammps_ani_torch.parallel import domain as pdom
    from lammps_ani_torch.parallel.sim import DomainSimulation

    data = water30_box(rep)
    masses = data.masses_by_type[data.species]
    pot = zoo.ani1xnr(num_models=1, seed=1, dtype=torch.float64,
                      device=device)
    dspec = pdom.auto_domain_spec(data.n_atoms, data.box_h, (1, 1, 1),
                                  max(5.1, pot.spec.cutoff) + 1.0, k_max=128)
    out = {}
    for name, m in (("process_group", mesh), ("local", None)):
        dsim = DomainSimulation(pot, dspec, cutoff=5.1, skin=1.0,
                                rebuild_every=10, dt=0.25,
                                dtype=torch.float64, device=device,
                                engine="pallas_asn", mesh=m)
        st = dsim.init_state(data.species, masses, data.positions,
                             make_box(data, torch.float64, device),
                             temp=300.0, seed=1)
        ev = dsim.evaluate(st)
        run, _ = dsim.run(st, steps)
        out[name] = {"engine": dsim.engine, "pe": ev.pe.cpu().numpy(),
                     "virial": ev.virial.cpu().numpy(),
                     "force": dsim.gather(ev, "force"),
                     "pos": dsim.gather(run, "pos"),
                     "vel": dsim.gather(run, "vel")}
    pg, loc = out["process_group"], out["local"]
    line = {"atoms": data.n_atoms, "steps": steps, "engine": pg["engine"],
            "pe": float(pg["pe"]),
            **{f"{k}_bit_for_bit": bool(np.array_equal(pg[k], loc[k]))
               for k in ("pe", "force", "virial", "pos", "vel")}}
    line["ok"] = all(line[f"{k}_bit_for_bit"] for k in (
        "pe", "force", "virial", "pos", "vel")) and all(
        o["engine"] == "pallas_asn" for o in out.values())
    return line


def _timed_md(sim, state, device, chunk, chunks, calls=None):
    """1 warm chunk, then the counts zeroed and `chunks` timed chunks,
    the counts read, then one chunk under torch.profiler (with the NCCL
    kernels as a group): (state, line)."""
    state, _ = sim.run(state, chunk)
    _reset_all_counts()
    if calls is not None:
        calls.update({k: 0 for k in calls})
    state, rows, chunk_ms = _run_timed(sim, state, chunks, device,
                                       chunk=chunk)
    steps = len(rows)
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    line = {**_md_numbers(sim, rows, chunk_ms), "launches": launches,
            "plain_calls": dict(asn.PLAIN_CALLS),
            "collectives_per_step": (None if calls is None else
                                     {k: v / steps for k, v in calls.items()})}
    groups = profile_groups(ASN_KERNELS) + (("nccl", ("nccl", "Nccl")),)
    state, prof = profile_chunk(sim, state, ASN_KERNELS, groups=groups,
                                chunk=chunk)
    line["profile"] = {k: prof[k] for k in (
        "device_busy_ms_per_step", "device_idle_share",
        "unprofiled_ms_per_step", "device_ms_per_step_by_group")}
    return state, line


def distributed_md(device, mesh, start, chunks=3):
    """The domain phase's early-earth system (config_50k.json: ANI-1xnr at
    full width, one model, seed 1; NoseHoover 300 K, dt 0.25 fs, a rebuild
    every 10) from its relaxed start, f32, as one shard on mesh (1,1,1):
    the process group, then `LocalMesh` (each: the engine pallas_asn; two
    chunks from the same state, bit for bit across the two; `_timed_md`;
    every gid once), then the single-device pallas_asn `Simulation`
    (`_timed_md`)."""
    from lammps_ani_torch.parallel import domain as pdom
    from lammps_ani_torch.parallel.sim import DomainSimulation

    cfg = start["cfg"]
    every = int(cfg["rebuild_every"])
    n = len(start["species"])
    pot = zoo.ani1xnr(num_models=int(cfg["num_models"]), seed=1,
                      dtype=torch.float32, device=device)
    rlist = max(float(cfg["cutoff"]), pot.spec.cutoff) + float(cfg["skin"])
    dspec = pdom.auto_domain_spec(n, start["box_h"], (1, 1, 1), rlist,
                                  k_max=int(cfg["k_max"]))
    box = Box(h=torch.tensor(start["box_h"], device=device),
              origin=torch.tensor(start["box_origin"], device=device))

    def nh():
        return integrate.NoseHoover(temp=float(cfg["stages"][0][0]),
                                    tdamp=float(cfg["tdamp"]))

    out, pairs = {}, {}
    for name, m in (("process_group", mesh), ("local", None)):
        dsim = DomainSimulation(
            pot, dspec, cutoff=float(cfg["cutoff"]), skin=float(cfg["skin"]),
            rebuild_every=every, dt=float(cfg["dt"]), dtype=torch.float32,
            device=device, integrator=nh(), mesh=m)
        t0 = time.perf_counter()
        state = dsim.init_state(start["species"], start["mass"],
                                start["pos"], box, vel=start["vel"])
        _sync(device)
        setup_s = time.perf_counter() - t0
        a, _ = dsim.run(state, every)
        b, _ = dsim.run(a, every)
        pairs[name] = [(x.pos, x.vel, x.force, x.pe, x.virial, x.gid)
                       for x in (a, b)]
        state, line = _timed_md(dsim, b, device, every, chunks,
                                getattr(dsim.mesh, "calls", None))
        gid = state.gid.cpu().numpy()
        line.update(engine=dsim.engine, setup_s=setup_s,
                    sizing=dsim.sizing(), regrow_kinds=dsim.regrow_kinds,
                    gids_once=bool(np.array_equal(np.sort(gid[gid >= 0]),
                                                  np.arange(n))))
        out[name] = line
        del dsim, state, a, b
        torch.cuda.empty_cache()
    same = all(identical(x, y) for x, y in zip(pairs["process_group"],
                                               pairs["local"]))
    del pairs
    sim = Simulation(
        potential=pot, species=start["species"], masses=start["mass"],
        nbr=NeighborConfig(cutoff=float(cfg["cutoff"]),
                           skin=float(cfg["skin"]), k_max=128,
                           ghost_capacity=max(4096, n // 2),
                           use_cell_list=True, cell_capacity=32,
                           rebuild_every=every),
        dt=float(cfg["dt"]), dtype=torch.float32, device=device,
        engine="pallas_asn", integrator=nh())
    state = sim.init_state(start["pos"], box, vel=start["vel"])
    _, line = _timed_md(sim, state, device, every, chunks)
    line["engine"] = sim.engine
    out["single_device"] = line
    del sim, state
    torch.cuda.empty_cache()
    return {"atoms": n, "mesh_shape": [1, 1, 1], "dtype": "float32",
            "two_chunks_bit_for_bit_process_group_vs_local": same, **out}


def distributed_cli(tmp, rep=4, steps=20, timeout=300):
    """`torchrun --standalone --nproc_per_node 1 -m lammps_ani_torch.run
    ... --mesh_shape 1 1 1` (NCCL, one shard a rank) under a time limit,
    and the same command in this process (`LocalMesh`), on the reference
    tile x rep^3 with velocities (1,920 atoms) written by the port's
    writer; ANI-2x, f64, NoseHoover 300 K, dt 0.25 fs, `steps` steps, a
    rebuild, a DCD frame and a restart every 10, thermo every 5: the thermo
    YAML, the final frame and the restart's positions and velocities of
    the two, and what torchrun printed."""
    import contextlib
    import io

    from lammps_ani_torch import run as cli
    from lammps_ani_torch.io import dump as dumpio
    from lammps_ani_torch.io import lammps_data as ldio

    data = water30_box(rep)
    data = dataclasses.replace(data, velocities=0.002 * np.random.default_rng(
        3).standard_normal((data.n_atoms, 3)))
    path = os.path.join(tmp, "water.data")
    ldio.write_lammps_data(path, data)

    def argv(tag):
        """A JSON config's path: torchrun's own parser would take a flag
        that abbreviates one of its options (--log)."""
        cfg = {"data": path, "model": "ani2x", "num_models": 1,
               "precision": "double", "dt": 0.25, "steps": steps,
               "rebuild_every": 10, "thermo_every": 5, "ensemble": "nvt",
               "temp": 300.0, "tdamp": 50.0, "dump_format": "dcd",
               "dump": os.path.join(tmp, f"{tag}.dcd"), "dump_every": 10,
               "log": os.path.join(tmp, f"{tag}.yaml"),
               "restart": os.path.join(tmp, f"{tag}.npz"),
               "restart_every": 10, "mesh_shape": [1, 1, 1]}
        cfg_path = os.path.join(tmp, f"{tag}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        return [cfg_path]

    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "lammps_ani_torch.run",
         *argv("torchrun")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"distributed cli: torchrun exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-3000:]}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv("local"))
    local_s = time.perf_counter() - t0
    got = {}
    for tag in ("torchrun", "local"):
        with np.load(os.path.join(tmp, f"{tag}.npz")) as z:
            got[tag] = (dumpio.read_thermo_yaml(
                os.path.join(tmp, f"{tag}.yaml")),
                dumpio.read_dcd(os.path.join(tmp, f"{tag}.dcd")),
                z["pos"], z["vel"])
    (t_rows, t_frames, t_pos, t_vel), (l_rows, l_frames, l_pos, l_vel) = (
        got["torchrun"], got["local"])
    thermo_err = max(float(np.max(np.abs(np.asarray(t_rows[k])
                                         - np.asarray(l_rows[k]))
                                  / max(np.abs(l_rows[k]).max(), 1e-300)))
                     for k in l_rows)
    perf = [x for x in proc.stdout.splitlines()
            if x.startswith("# Performance:")]
    line = {"atoms": data.n_atoms, "steps": steps,
            "torchrun_s": torchrun_s, "local_s": local_s,
            "thermo_rows": len(t_rows["step"]),
            "thermo_bit_for_bit": all(np.array_equal(t_rows[k], l_rows[k])
                                      for k in l_rows),
            "thermo_max_rel_err": thermo_err,
            "frames": list(t_frames.shape),
            "final_frame_bit_for_bit": bool(
                t_frames.shape == l_frames.shape
                and np.array_equal(t_frames[-1], l_frames[-1])),
            "restart_bit_for_bit": bool(np.array_equal(t_pos, l_pos)
                                        and np.array_equal(t_vel, l_vel)),
            "torchrun_performance": perf, "local_performance": [
                x for x in out.getvalue().splitlines()
                if x.startswith("# Performance:")]}
    line["ok"] = (line["thermo_rows"] == steps // 5 and thermo_err <= 1e-12
                  and line["final_frame_bit_for_bit"]
                  and line["restart_bit_for_bit"] and len(perf) == 1
                  and line["frames"][0] == steps // 10)
    return line


def phase_distributed(start, chunks=3):
    """The process-group backend on one card: a one-rank NCCL group in
    this process (`_nccl_group`; no fallback to gloo) and
    `ProcessGroupMesh((1, 1, 1))` on it; `distributed_f64` (the group
    against `LocalMesh`, bit for bit), `distributed_md` (the early-earth
    system at full width as one shard: the group, `LocalMesh` and the
    single-device engine; the group's two chunks bit for bit against
    `LocalMesh`'s, every gid once, the eight asn kernels launched in its
    timed chunks and no plain version), with the group destroyed after;
    then `distributed_cli` (the CLI under torchrun against the in-process
    route). The phase's seconds."""
    import tempfile

    import torch.distributed as dist

    from lammps_ani_torch.parallel.comm import ProcessGroupMesh

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    card = torch.device("cuda", torch.cuda.current_device())
    _nccl_group(tmp, card)
    try:
        mesh = ProcessGroupMesh((1, 1, 1), device=card)
        backend = mesh.backend
        f64 = distributed_f64(card, mesh)
        md = distributed_md(card, mesh, start, chunks)
    finally:
        dist.destroy_process_group()
    cli_line = distributed_cli(tmp)
    pg = md["process_group"]
    line = {"phase": "distributed", "backend": backend, "f64": f64,
            "md": md, "cli": cli_line,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    launched = all(v > 0 for v in pg["launches"].values())
    if not (backend == "nccl" and f64["ok"] and cli_line["ok"]
            and md["two_chunks_bit_for_bit_process_group_vs_local"]
            and pg["engine"] == "pallas_asn" and pg["gids_once"]
            and launched and not any(pg["plain_calls"].values())):
        raise AssertionError(
            f"distributed: backend {backend}, f64 {f64['ok']}, cli "
            f"{cli_line['ok']}, engine {pg['engine']}, two chunks "
            f"{md['two_chunks_bit_for_bit_process_group_vs_local']}, gids "
            f"{pg['gids_once']}, launches {pg['launches']}, plain "
            f"{pg['plain_calls']}")


# ---------------------------------------------------------------------------
# The example workflows (lammps_ani_torch/examples)
# ---------------------------------------------------------------------------

# a dihedral across two molecules of the reference tile (H 1, O 0 | O 3, H 4)
UMBRELLA_PHI = (1, 0, 3, 4)


def _rows_finite(rows):
    return all(np.isfinite(r[key]) for stage in rows for r in stage
               for key in ("pe", "ke", "temp", "press", "etotal"))


def examples_campaign(device, tmp, extra_stage=(500.0, 10)):
    """examples/early_earth/config_50k.json as shipped (49,000 atoms from
    early_earth_50k.data, ANI-1xnr at full width, one model, auto_spec,
    k_max 112, cutoff 5.1, skin 1.0, dt 0.25 fs, its stage of 10 steps at
    300 K) with a second stage of 10 steps at 500 K, through
    `run_stages.run_campaign` on `LocalMesh` (2,2,2) on the card, f32, from
    the data file as the JAX script starts, its restarts under `tmp`; the
    counts zeroed just before and read just after. Then stage 1 again in a
    fresh engine from stage 0's restart (`first_stage=1`): its thermo rows
    and final positions against the continuous campaign's, bit for bit.
    Raises where a gate fails; returns the line."""
    from lammps_ani_torch.examples.early_earth import run_stages as rs

    cfg = rs.load_config(os.path.join(EARLY_EARTH, "config_50k.json"))
    cfg.update(data=os.path.join(EARLY_EARTH, cfg["data"]),
               stages=cfg["stages"] + [list(extra_stage)],
               restart_prefix=os.path.join(tmp, "early_earth_50k.stage"))
    printed = []
    _reset_all_counts()
    t0 = time.perf_counter()
    c = rs.run_campaign(cfg, device=device, log=printed.append)
    _sync(torch.device(device))
    wall = time.perf_counter() - t0
    launches = {name: asn.LAUNCHES[name] for name in ASN_KERNELS}
    plain = dict(asn.PLAIN_CALLS)
    roll = {k: v for k, v in ar.LAUNCHES.items() if v}
    final_pos = c.dsim.gather(c.state, "pos")
    engine, sizing = c.dsim.engine, c.dsim.sizing()
    regrows = dict(c.dsim.regrow_kinds)
    del c.dsim
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    r = rs.run_campaign(cfg, device=device, log=lambda line: None,
                        first_stage=1)
    _sync(torch.device(device))
    resume_wall = time.perf_counter() - t1
    resume_rows_same = r.rows == c.rows[1:]
    resume_pos_same = bool(np.array_equal(
        r.dsim.gather(r.state, "pos"), final_pos))
    del r
    torch.cuda.empty_cache()
    steps = [int(st[1]) for st in cfg["stages"]]
    line = {"part": "campaign", "config": "examples/early_earth/"
            "config_50k.json", "data": "examples/early_earth/"
            "early_earth_50k.data", "start": "the data file",
            "atoms": int(len(final_pos)), "mesh_shape": cfg["mesh_shape"],
            "dtype": "float32", "engine": engine,
            "stages": cfg["stages"],
            "ms_per_step_by_stage": [sec / n * 1e3 for sec, n in
                                     zip(c.seconds, steps)],
            "seconds_by_stage": c.seconds,
            "ns_per_day_by_stage": [float(cfg["dt"]) * 86.4 / (sec / n * 1e3)
                                    for sec, n in zip(c.seconds, steps)],
            "rows": c.rows, "fragments": c.fragments,
            "printed": printed, "regrow_kinds": regrows,
            "launches": launches, "plain_calls": plain,
            "launches_per_step": {k: v / sum(steps)
                                  for k, v in launches.items()},
            "sizing": sizing, "campaign_seconds": wall,
            "resume": {"first_stage": 1, "seconds": resume_wall,
                       "rows_bit_for_bit": resume_rows_same,
                       "final_positions_bit_for_bit": resume_pos_same}}
    ok = (engine == "pallas_asn" and _rows_finite(c.rows)
          and all(v > 0 for v in launches.values())
          and not any(plain.values()) and not roll
          and resume_rows_same and resume_pos_same
          and any(x.startswith("# invariants OK") for x in printed))
    line["ok"] = ok
    if not ok:
        emit(line)
        raise AssertionError(
            f"examples campaign: engine {engine}, finite "
            f"{_rows_finite(c.rows)}, launches {launches}, plain {plain}, "
            f"roll {roll}, resume rows {resume_rows_same}, positions "
            f"{resume_pos_same}")
    return line


def examples_torchrun(tmp, device, n_water=480, timeout=300):
    """The campaign's `main` under `torchrun --standalone --nproc_per_node
    1` on a NCCL group (mesh (1,1,1): one card allows no more) on
    `generate.build(480)` (1,960 atoms, the JAX script's default), two
    stages of 10 steps (300 K, 500 K), auto_spec, against `run_campaign`
    on `LocalMesh` (1,1,1) in this process: the thermo YAML, both restarts
    and the final positions bit for bit. The torchrun process starts
    first, the `LocalMesh` run goes in this process meanwhile. Returns the
    line."""
    from lammps_ani_torch.examples.early_earth import generate
    from lammps_ani_torch.examples.early_earth import run_stages as rs
    from lammps_ani_torch.io import dump as dumpio
    from lammps_ani_torch.io.lammps_data import write_lammps_data

    data = generate.build(n_water)
    path = os.path.join(tmp, "early_earth.data")
    write_lammps_data(path, data)

    def cfg_of(tag):
        cfg = rs.load_config(None)
        cfg.update(data=path, mesh_shape=[1, 1, 1], auto_spec=True,
                   device=str(device),
                   stages=[[300.0, 10], [500.0, 10]], thermo_every=1,
                   restart_prefix=os.path.join(tmp, f"{tag}.stage"),
                   log=os.path.join(tmp, f"{tag}.yaml"))
        return cfg

    cfg_path = os.path.join(tmp, "torchrun.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_of("torchrun"), f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m",
         "lammps_ani_torch.examples.early_earth.run_stages", cfg_path],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t1 = time.perf_counter()
        local = rs.run_campaign(cfg_of("local"), device=device,
                                log=lambda line: None)
        local_s = time.perf_counter() - t1
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"examples torchrun: exited {proc.returncode}: "
                             f"{out[-3000:]}")
    yaml = {t: dumpio.read_thermo_yaml(os.path.join(tmp, f"{t}.yaml"))
            for t in ("torchrun", "local")}
    restarts_same = True
    for i in range(2):
        with np.load(os.path.join(tmp, f"torchrun.stage{i}.npz")) as a, \
                np.load(os.path.join(tmp, f"local.stage{i}.npz")) as b:
            restarts_same &= (set(a.files) == set(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files
                if k != "__meta__"))
    with np.load(os.path.join(tmp, "torchrun.stage1.npz")) as z:
        pos_same = bool(np.array_equal(
            z["pos"], local.dsim.gather(local.state, "pos")))
    line = {"part": "torchrun", "atoms": data.n_atoms,
            "mesh_shape": [1, 1, 1],
            "backend": "nccl" if str(device).startswith("cuda") else "gloo",
            "engine": local.dsim.engine, "stages": [[300.0, 10], [500.0, 10]],
            "torchrun_s": torchrun_s, "local_s": local_s,
            "local_ms_per_step_by_stage": [sec / 10 * 1e3
                                           for sec in local.seconds],
            "thermo_rows": len(yaml["torchrun"].get("step", [])),
            "thermo_bit_for_bit": yaml["torchrun"] == yaml["local"],
            "restarts_bit_for_bit": restarts_same,
            "final_positions_bit_for_bit": pos_same,
            "printed_once": out.count("# stage 0:") == 1
            and out.count("# invariants OK") == 1,
            "torchrun_tail": out.splitlines()[-3:]}
    line["ok"] = (line["thermo_rows"] == 20 and line["thermo_bit_for_bit"]
                  and restarts_same and pos_same and line["printed_once"]
                  and local.dsim.engine == "pallas_asn")
    if not line["ok"]:
        emit(line)
        raise AssertionError(f"examples torchrun: {line}")
    return line


def examples_umbrella(device, tmp, windows=2, steps=24, every=4):
    """`run_umbrella` on the card on the reference tile (WATER30_POS,
    written by the port's writer) with the dihedral UMBRELLA_PHI, `windows`
    windows of `steps` steps, a sample every `every`: its samples against
    a direct `bias.run_windows` call with the same arguments, bit for bit;
    then `analyze_umbrella.pmf` over its npz."""
    import functools

    from lammps_ani_torch.examples.alanine_dipeptide_umbrella import (
        analyze_umbrella, run_umbrella)
    from lammps_ani_torch.io.lammps_data import (read_lammps_data,
                                                 write_lammps_data)
    from lammps_ani_torch.md import bias

    path = os.path.join(tmp, "water30.data")
    write_lammps_data(path, water30_box(1))
    out = os.path.join(tmp, "umbrella_samples.npz")
    t0 = time.perf_counter()
    centers, samples = run_umbrella.run_umbrella(
        path, phi=UMBRELLA_PHI, n_windows=windows, steps_per_window=steps,
        sample_every=every, device=device, out=out)
    _sync(torch.device(device))
    run_s = time.perf_counter() - t0
    data = read_lammps_data(path)
    make = functools.partial(
        run_umbrella.make_sim, data, zoo.ani2x(num_models=1, device=device),
        generator=torch.Generator(device=device).manual_seed(
            run_umbrella.SEED), device=device)
    ref = bias.run_windows(
        make, data.positions, Box.from_lammps(
            *data.box_bounds.ravel(), *data.tilt, device=device),
        centers, k=40.0, cv_factory=lambda: bias.dihedral_cv(*UMBRELLA_PHI),
        steps_per_window=steps, sample_every=every, seed=run_umbrella.SEED,
        periodic=2 * np.pi)
    t1 = time.perf_counter()
    x, pmf, f = analyze_umbrella.pmf(out)
    wham_s = time.perf_counter() - t1
    same = all(np.array_equal(a, b) for a, b in zip(samples, ref))
    line = {"part": "umbrella", "atoms": data.n_atoms,
            "phi": list(UMBRELLA_PHI), "windows": windows, "steps": steps,
            "sample_every": every, "samples": [s.tolist() for s in samples],
            "samples_bit_for_bit_run_windows": same, "run_s": run_s,
            "wham_s": wham_s, "pmf_finite_bins": int(np.isfinite(pmf).sum()),
            "free_energies": f.tolist()}
    line["ok"] = (same and all(len(s) == steps // every
                               and np.isfinite(s).all() for s in samples)
                  and line["pmf_finite_bins"] > 0
                  and bool(np.isfinite(f).all()))
    if not line["ok"]:
        emit(line)
        raise AssertionError(f"examples umbrella: {line}")
    return line


def examples_analyze_traj(cli_files, device):
    """`analyze_traj` over the DCD the `cli` phase wrote (4 frames of the
    1,440-atom mixture), on the card: its rows against
    `analysis.fragments` applied to `read_dcd`'s frames."""
    from collections import Counter

    from lammps_ani_torch.analysis.fragments import fragments
    from lammps_ani_torch.examples.combustion import analyze_traj
    from lammps_ani_torch.io.dump import read_dcd
    from lammps_ani_torch.io.lammps_data import read_lammps_data

    t0 = time.perf_counter()
    rows = analyze_traj.formula_rows(cli_files["dcd"], cli_files["data"],
                                     device=device)
    seconds = time.perf_counter() - t0
    data = read_lammps_data(cli_files["data"])
    box_h = np.diag(data.box_bounds[:, 1] - data.box_bounds[:, 0])
    ref = [(i, Counter(fragments(data.species, pos, box_h, device=device)[
        1]).most_common(analyze_traj.TOP))
        for i, pos in enumerate(read_dcd(cli_files["dcd"]))]
    line = {"part": "analyze_traj", "frames": len(rows), "seconds": seconds,
            "rows": rows, "equal_to_fragments": rows == ref}
    line["ok"] = line["equal_to_fragments"] and len(rows) == 4
    if not line["ok"]:
        emit(line)
        raise AssertionError(f"examples analyze_traj: {line}")
    return line


def phase_examples(device, cli_files):
    """The example workflows on the card, one part after another: the
    umbrella windows, analyze_traj, the torchrun campaign (its `LocalMesh`
    twin in this process while it runs), then the 49,000-atom campaign
    alone on the card. One line a part (its seconds and the card's name
    and power limit) and the phase's seconds."""
    import tempfile

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        line = fn(*args)
        line.update(seconds_part=time.perf_counter() - t0, card=card)
        emit({"phase": "examples", **line})
        parts[name] = line["seconds_part"]

    part("umbrella", examples_umbrella, device, tmp)
    part("analyze_traj", examples_analyze_traj, cli_files, device)
    part("torchrun", examples_torchrun, tmp, device)
    part("campaign", examples_campaign, device, tmp)
    emit({"phase": "examples", "part": "summary", "seconds_by_part": parts,
          "seconds": time.perf_counter() - t_phase, "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    device = "cuda"
    smi = nvidia_smi_line()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    phase_build()
    phase_kernels_small(device)
    phase_potential(device)
    phase_asn_kernels(device)
    phase_asn_blocks(device)
    sim, state, launches, main_line = phase_main(device)
    prof_line = phase_profile(sim, state)
    roll_sim, roll_state, roll_launches, work_start = phase_roll_md(
        device, sim, state)
    rows = phase_timing(roll_sim, roll_state, roll_launches, work_start)
    rows += phase_asn_timing(device, sim, state, launches, roll_sim)
    rows += phase_asn_channels(device, sim, state)
    rows += phase_blocks_md(device, sim, state)
    phase_pair_stage(device)
    phase_mirror(device)
    phase_mirror_md(device, sim, state)
    rows += phase_probes(device)
    phase_nvt_npt(device, sim, state)
    phase_ani1xnr_kernels(device)
    x_rows, sim_x, state_x = phase_ani1xnr_md(device)
    rows += x_rows
    cli_files = phase_cli(device)
    phase_rattle_md(device)
    phase_bias_md(device, sim, state, main_line, prof_line)
    phase_trace(sim, state)
    phase_fragments(device, sim_x, state_x)
    phase_equilibrate_tile(device)
    domain_rows, start = phase_domain(device)
    rows += domain_rows
    phase_distributed(start)
    phase_examples(device, cli_files)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
