"""Physical constants and unit conversions for the `real` unit system.

The engine works in LAMMPS `real` units (cf. reference tests/in.lammps `units
real`, enforced at the reference's src/pair_ani.cpp:44-46):

  - distance    : Angstrom
  - time        : femtosecond
  - energy      : kcal/mol
  - velocity    : Angstrom / fs
  - force       : kcal/mol / Angstrom
  - temperature : Kelvin
  - pressure    : atmosphere
  - mass        : g/mol

The ANI potential itself works in Hartree; the conversion happens at the
potential boundary exactly like the reference
(`hartree2kcalmol` at the reference's src/ani_csrc/ani.h:9).
"""

# Hartree -> kcal/mol (reference: src/ani_csrc/ani.h:9)
HARTREE2KCALMOL = 627.5094738898777

# Hartree -> eV (CODATA)
HARTREE2EV = 27.211386245988

# Boltzmann constant in kcal/mol/K (LAMMPS real units `boltz`)
BOLTZ = 0.0019872067

# mv^2 -> energy conversion: E_kin = 0.5 * MVV2E * m * v^2
# (LAMMPS real units `mvv2e`; v in A/fs, m in g/mol, E in kcal/mol)
_FTM2V_DENOM = 48.88821291 * 48.88821291
MVV2E = _FTM2V_DENOM

# force/mass -> acceleration conversion: a = FTM2V * F / m
# (LAMMPS real units `ftm2v`)
FTM2V = 1.0 / _FTM2V_DENOM

# N k_B T / V -> pressure conversion (LAMMPS real units `nktv2p`,
# cf. reference tests/test_lmp_with_ase.py:133)
NKTV2P = 68568.415

# atmosphere -> kcal/mol/A^3 (inverse of NKTV2P)
ATM2ENGVOL = 1.0 / NKTV2P

# femtosecond per LAMMPS-real time unit
FEMTOSECOND = 1.0

# (g/mol)/A^3 -> g/cm^3 conversion divisor: density = M / (V * AVOGADRO_VOL)
AVOGADRO_VOL = 0.602214076

# ns/day from ms/step and timestep(fs):
#   steps/day = 86400e3 ms / ms_per_step; ns/day = steps/day * dt_fs / 1e6
def ns_per_day(dt_fs: float, ms_per_step: float) -> float:
    return dt_fs * 86.4 / ms_per_step
