"""The control comes out not correct (on a card).

The control is the reference in f32 with TF32 products (the precision
below the configuration's f32 with TF32 off) put in the program's place.
At a size a test run holds (tests/_small.py, on the card's asn engine),
the program's chunk judged by the cell's limits is correct and the
control's is not. `python -m portbench.control` reads both at the
cells' own sizes."""

import pytest

from portbench import check, md, system as sysmod, weights

from ._small import small_cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["water-ani2x-415k-centred",
                                  "combustion-ani1xnr-92k-centred"])
def test_control_is_not_correct(card, cell):
    c = small_cell(cell, engine=None)
    cfg, traffic = c["cfg"], c["traffic"]
    system = sysmod.build(traffic, cfg)
    params = weights.draw(cfg, card)
    run, _ = md.build(cfg, traffic, system, params, 2 ** 31 + 5, card)
    md.warm_up(run, traffic)
    win = md.window(run, traffic, 1.0)
    case = check.case_of(run, traffic, system, win.clean)
    got, bad = check.readings(cfg, params, case, card, control=True)
    limits = c["limits"]["limits"]
    assert check.verdict(got, limits), got
    assert not check.verdict(bad, limits), bad
