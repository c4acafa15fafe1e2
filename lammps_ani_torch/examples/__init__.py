"""The example workflows of examples/ as entry points of the port.

Each module is a counterpart of a script of examples/ (a hyphen in a
folder's name becomes an underscore), with a function API and a `main`
that prints what the script prints:

    python -m lammps_ani_torch.examples.combustion.prepare_system 160 mix.data
    python -m lammps_ani_torch.examples.combustion.analyze_traj c.dcd mix.data
    python -m lammps_ani_torch.examples.early_earth.generate 480 ee.data
    python -m lammps_ani_torch.examples.early_earth.run_stages config.json
    python -m lammps_ani_torch.examples.alanine_dipeptide_umbrella.run_umbrella \
        system.data
    python -m lammps_ani_torch.examples.alanine_dipeptide_umbrella.analyze_umbrella

They keep the scripts' defaults and seeds, and run on the card unless
given `--device cpu` (`device="cpu"`).
"""
