"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (`run.execute`, past the look for a
card) on the CPU, at a size a test run holds (tests/_small.py), with the
cell's own limits, and one fault planted in the port's Simulation:

  unchanged  a step that returns its state unchanged (its step count
             advanced);
  half       half of the atoms' forces left out (zero);
  altered    one answer altered where it is produced: one atom's force
             moved by 0.5 kcal/mol/A at every evaluation.

The exchange between chips does not exist in these one-chip cells. The
same run without a fault comes out correct."""

import pytest
import torch

from portbench import run as runmod

from ._small import small_cell

CELLS = ("water-ani2x-415k-centred", "combustion-ani1xnr-92k-centred")


def _plant(monkeypatch, fault):
    from lammps_ani_torch.md import simulation

    sim_cls = simulation.Simulation
    step, forces = sim_cls._step, sim_cls._forces

    def unchanged(self, st):
        new, deficit = step(self, st)
        return st.replace(step=new.step), deficit

    def half(self, pos, box, bins, step=0):
        pe, f, w, deficit = forces(self, pos, box, bins, step)
        f = f.clone()
        f[f.shape[0] // 2:] = 0.0
        return pe, f, w, deficit

    def altered(self, pos, box, bins, step=0):
        pe, f, w, deficit = forces(self, pos, box, bins, step)
        f = f.clone()
        f[0, 0] += 0.5
        return pe, f, w, deficit

    if fault == "unchanged":
        monkeypatch.setattr(sim_cls, "_step", unchanged)
    elif fault is not None:
        monkeypatch.setattr(sim_cls, "_forces",
                            {"half": half, "altered": altered}[fault])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    _plant(monkeypatch, fault)
    result, values, limits, _ = runmod.execute(
        small_cell(cell), 2 ** 31 + 17, 0.5, False, torch.device("cpu"))
    failed = {k: v for k, v in values.items()
              if k in limits and not v <= limits[k]}
    if fault is None:
        assert result["correct"], values
    else:
        assert not result["correct"] and failed, (fault, values)
    assert list(result["compared"]) == list(limits)
