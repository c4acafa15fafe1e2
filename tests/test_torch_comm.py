"""The process-group backend of the port's mesh communicator
(lammps_ani_torch/parallel/comm.py, `ProcessGroupMesh`) against the
in-process mesh (`LocalMesh`) over gloo on the CPU.

Meshes: (1,1,1) as a one-rank group in this process; (3,2,1) over 6
ranks, where axis x has distinct left and right neighbors, y one rank on
both sides and z is a self-image; (2,2,2) over 8 ranks. One spawn a mesh
for the module (tests/_dist_workers.py); every rank runs `comm_case` on
seeded per-shard blocks and this process compares with `LocalMesh`'s run
of the same case: the shifts both ways on every axis (float, integer and
bool blocks) and their backward bit for bit, the backward also against
the inverse shift; psum (exact where the sum is, else 1e-15 relative),
pmax (bools too), the coordinates and the all-gather exactly; the rank
generators. A mesh whose size is not the world size raises.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lammps_ani_torch.parallel.comm import LocalMesh, ProcessGroupMesh

from ._dist_workers import PG_TIMEOUT, Ranks, comm_case

MESHES = [(1, 1, 1), (3, 2, 1), (2, 2, 2)]
SHIFTS = [f"{axis}{d:+d}" for axis in range(3) for d in (1, -1)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (each rank's results, LocalMesh's)} and the mismatch's
    message."""
    d = tmp_path_factory.mktemp("comm")
    out = {}
    with Ranks("comm", (3, 2, 1), d / "321") as a, \
            Ranks("comm", (2, 2, 2), d / "222") as b:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(d / "store111"), 1), rank=0,
            world_size=1, timeout=PG_TIMEOUT)
        try:
            out[(1, 1, 1)] = [comm_case(lambda: ProcessGroupMesh((1, 1, 1)))]
            try:
                ProcessGroupMesh((2, 1, 1))
                mismatch = None
            except ValueError as err:
                mismatch = str(err)
        finally:
            dist.destroy_process_group()
        out[(3, 2, 1)], out[(2, 2, 2)] = a.join(), b.join()
    return ({m: (res, comm_case(lambda: LocalMesh(m)))
             for m, res in out.items()}, mismatch)


def ranks_and_local(runs, mesh):
    res, local = runs[0][mesh]
    assert len(res) == int(np.prod(mesh))
    return res, local


@pytest.mark.parametrize("kind", ["float", "int", "bool"])
@pytest.mark.parametrize("mesh", MESHES)
def test_shift_matches_local(runs, mesh, kind):
    res, local = ranks_and_local(runs, mesh)
    for r, out in enumerate(res):
        for tag in SHIFTS:
            got, ref = out[f"shift_{kind}{tag}"], local[f"shift_{kind}{tag}"]
            assert got.dtype == ref.dtype and torch.equal(got, ref[r:r + 1]), \
                (r, tag)


@pytest.mark.parametrize("mesh", MESHES)
def test_shift_backward_is_the_inverse_shift(runs, mesh):
    res, local = ranks_and_local(runs, mesh)
    for tag in SHIFTS:
        assert torch.equal(local["grad" + tag], local["inverse" + tag])
    for r, out in enumerate(res):
        for tag in SHIFTS:
            assert torch.equal(out["grad" + tag], local["grad" + tag][r:r + 1])
            assert torch.equal(out["grad" + tag], out["inverse" + tag])


@pytest.mark.parametrize("mesh", MESHES)
def test_reductions_match_local(runs, mesh):
    res, local = ranks_and_local(runs, mesh)
    for out in res:
        for key in ("psum_quarter", "psum_int", "pmax_float", "pmax_int",
                    "pmax_bool", "pmax_rare"):
            assert out[key].dtype == local[key].dtype
            assert torch.equal(out[key], local[key]), key
        np.testing.assert_allclose(out["psum_float"], local["psum_float"],
                                   rtol=1e-15, atol=0)
        # every rank holds the same bits
        assert torch.equal(out["psum_float"], res[0]["psum_float"])
    assert local["pmax_rare"].any() and not local["pmax_rare"].all()


@pytest.mark.parametrize("mesh", MESHES)
def test_coordinates_and_all_gather_match_local(runs, mesh):
    res, local = ranks_and_local(runs, mesh)
    assert local["local"] == list(range(len(res))) and local["rank"] == 0
    for r, out in enumerate(res):
        assert out["local"] == [r] and out["rank"] == r
        assert torch.equal(out["coords"], local["coords"][r:r + 1])
        assert torch.equal(out["axis_index"], local["axis_index"][r:r + 1])
        for key in ("gather_float", "gather_int", "gather_bool"):
            assert out[key].dtype == local[key].dtype
            assert torch.equal(out[key], local[key]), key


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_generators(runs, mesh):
    """`LocalMesh` draws from the given generator; each rank from its own,
    seeded from that generator's seed and the rank."""
    res, local = ranks_and_local(runs, mesh)
    g = torch.Generator().manual_seed(7)
    assert torch.equal(local["draw"],
                       torch.randn(4, generator=g, dtype=torch.float64))
    draws = {tuple(out["draw"].tolist()) for out in res}
    assert len(draws) == len(res)


def test_world_size_mismatch_raises(runs):
    msg = runs[1]
    assert msg is not None and "(2, 1, 1)" in msg and "2 shards" in msg \
        and "1 ranks" in msg
