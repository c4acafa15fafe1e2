"""The probe kernels' floors and layouts (lammps_ani_torch/probes,
csrc/probes.cu) on the CPU, against counts and transcriptions in numpy.

- micro_gather.compact_sector_bytes against a brute-force count of the
  distinct 32-byte sectors each row's gather touches, on small seeded
  inputs with out-of-range indices, rows that start mid-sector, and K not
  a multiple of 4; micro_gather.onehot_steps against R K W.
- micro_kernel_variants.variant_ops, fused (the kernel's form) and not,
  against its itemised per-pair formula for every stage.
- The ONEHOT kernel's arithmetic, transcribed: each lane's columns (the
  whole 128-lane blocks as 16-byte vectors, the rest 32 lanes at a time),
  its 32 sums from +0 by fma(weight, value, sum) in the kernel's order,
  the reduce-scatter of aev_common.cuh; bit for bit the plain version on
  rows with zeros of both signs, out-of-range indices and non-finite
  values, for W with and without whole vector blocks.
- The radial variant kernel's walk, transcribed: each block's rows and
  the stages of the two-stage ring, so every (row, candidate) is summed
  once, in index order, from the stage the copy filled.
- The ValueError the compact wrapper raises, before any launch, on an x
  that does not start on a 16-byte boundary.

Each test takes well under a second.
"""

import numpy as np
import pytest
import torch

from lammps_ani_torch.probes import micro_gather as tmg
from lammps_ani_torch.probes import micro_kernel_variants as tmv

SECTOR_CASES = [(1, 3, 45, 8), (1, 2, 40, 12), (2, 3, 200, 10),
                (1, 4, 540, 32)]


def _sectors_brute(idx, k, w):
    rows = idx.reshape(-1, idx.shape[-1])[:, :k]
    total = 0
    for r, row in enumerate(rows):
        total += len({(r * w + int(s)) // 8 for s in row if 0 <= s < w})
    return total


@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_bytes_match_a_brute_force_count(case):
    inp = tmg.make_inputs(*case, seed=sum(case))
    w, k = inp["x"].shape[2], inp["k"]
    inp["idx"][..., 0] = w + 5  # out of range: reads nothing
    inp["idx"][..., 1] = -2
    idx = inp["idx"].numpy()
    r = idx.shape[0] * idx.shape[1]
    want = 32 * _sectors_brute(idx, k, w) + 2 * 4 * r * k
    assert tmg.compact_sector_bytes(inp) == want
    # never more than the bytes of every touched element's own sector
    assert want <= 32 * r * k + 8 * r * k


def test_onehot_steps_are_rows_outputs_lanes():
    inp = tmg.make_inputs(2, 3, 50, 7, seed=1)
    assert tmg.onehot_steps(inp) == (2 * tmg.T_ROWS * 3) * 7 * 50


def _per_pair(stage, fused):
    """variant_ops' itemised count of fp32 instructions a pair."""
    dist = 3 + 3 + 2 + 1  # subtractions, products, sums, the clamp
    pre = 1 + 2 + 4 + 1   # cutoff test, x, t, b
    term = 1 if fused else 2
    return {"geom_only": dist + 1,
            "geom_fc_exp": dist + pre + term,
            "recurrence16": dist + pre + 15 * 2 + 16,
            "full32": dist + pre + 15 * 2 + 32 * term,
            "full32_premask": dist + pre + 2 + 1 + 15 * 2 + 32,
            "full32_accum": dist + pre + 15 * 2 + 32 * term}[stage]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("stage", tmv.STAGES)
def test_variant_ops_match_the_itemised_count(stage, fused):
    nc, cap, w, n_in = 3, 5, 7, 11
    pairs = nc * cap * w
    got = tmv.variant_ops(stage, nc, cap, w, n_in=n_in, fused=fused)
    if stage == "geom_only":
        want = {"fp32": _per_pair(stage, fused) * pairs, "sfu": pairs}
    else:
        want = {"fp32": _per_pair(stage, fused) * pairs + 4 * n_in,
                "sfu": 3 * pairs}
    assert got == want
    if stage in ("full32", "full32_accum"):
        assert _per_pair(stage, True) == 79 and _per_pair(stage, False) == 111


def _reduce_scatter32(acc):
    """aev_common.cuh reduce_scatter32 over acc [32 lanes, 32 columns]:
    lane l ends with column l (each step: keep one half, add the other
    lane's other half)."""
    acc = acc.copy()
    lanes = np.arange(32)
    for width in (16, 8, 4, 2, 1):
        upper = (lanes & width) != 0
        new = acc.copy()
        for i in range(width):
            send = np.where(upper, acc[:, i], acc[:, i + width])
            keep = np.where(upper, acc[:, i + width], acc[:, i])
            new[:, i] = keep + send[lanes ^ width]
        acc = new
    return acc[:, 0]


def _onehot_row(xr, sel):
    """The ONEHOT kernel on one row: x [W] float32, sel [K] int32."""
    w, k = xr.shape[0], sel.shape[0]
    nfull = w // 128 if w % 4 == 0 else 0
    cols = []  # each lane's columns in the kernel's order
    for lane in range(32):
        c = [128 * b + 4 * lane + e for b in range(nfull) for e in range(4)]
        c += [j for j in range(128 * nfull + lane, w + 31, 32)
              if j - lane < w]
        cols.append(c)
    seen = sorted(j for c in cols for j in c if j < w)
    assert seen == list(range(w))  # every lane of the row once
    out = np.zeros(k, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for c0 in range(0, k, 32):
            want = np.full(32, np.nan, np.float32)
            n = min(32, k - c0)
            want[:n] = sel[c0:c0 + n].astype(np.float32)
            acc = np.zeros((32, 32), np.float32)
            for lane in range(32):
                for j in cols[lane]:
                    v = xr[j] if j < w else np.float32(0.0)
                    col = np.float32(j) if j < w else np.float32(np.nan)
                    weight = (want == col).astype(np.float32)
                    acc[lane] = acc[lane] + weight * v  # w v exact: fma
            out[c0:c0 + n] = _reduce_scatter32(acc)[:n]
    return out


@pytest.mark.parametrize("w,k", [(540, 32), (140, 40), (45, 9), (300, 70),
                                 (256, 33), (96, 8)])
def test_onehot_kernel_transcription_gives_the_plain_bits(w, k):
    rng = np.random.default_rng(w + k)
    x = rng.standard_normal((4, w)).astype(np.float32)
    x[0, :] = -np.abs(x[0, :])        # a row of negatives
    x[1, ::3] = 0.0
    x[1, 1::3] = -0.0                 # zeros of both signs
    x[3, 5] = np.inf                  # a non-finite lane: NaN elsewhere
    idx = rng.integers(0, w, (4, 128)).astype(np.int32)
    idx[:, 0] = w + 1                 # out of range
    idx[:, 1] = -1
    idx[1, 2:8] = np.arange(6)        # pick the signed zeros
    ref = tmg.compact_plain("onehot", torch.from_numpy(x)[None],
                            torch.from_numpy(idx)[None], k).numpy()[0]
    got = np.stack([_onehot_row(x[r], idx[r, :k]) for r in range(4)])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_array_equal(got.view(np.int32)[fin],
                                  ref.view(np.int32)[fin])


def _variant_walk(nc, w, grid, stage=128):
    """probe_radial_variant_kernel's loop for each block: the (row, first
    candidate) each ring stage is filled with, and the one each compute
    step reads, in order. Returns {row: [candidates summed, in order]}."""
    per_row = -(-w // stage)
    summed = {}
    for b in range(grid):
        rows = -(-(nc - b) // grid)
        total = rows * per_row
        if total == 0:
            continue
        ring = [None, None]
        r_next, j_next = b, 0
        ring[0] = (r_next, 0)
        r, jc = r_next, 0
        for t in range(total):
            j_next += 1
            if j_next == per_row:
                j_next, r_next = 0, r_next + grid
            if t + 1 < total:
                ring[(t + 1) & 1] = (r_next, j_next * stage)
            row, j0 = ring[t & 1]
            assert (row, j0) == (r, jc * stage)
            n = min(stage, w - j0)
            summed.setdefault(row, []).extend(range(j0, j0 + n))
            jc += 1
            if jc == per_row:
                jc, r = 0, r + grid
    return summed


@pytest.mark.parametrize("nc,w,grid", [(7, 300, 7), (10, 128, 3),
                                       (5, 864, 2), (9, 1, 4)])
def test_variant_ring_walk_sums_each_candidate_once_in_order(nc, w, grid):
    summed = _variant_walk(nc, w, grid)
    assert sorted(summed) == list(range(nc))
    for row in range(nc):
        assert summed[row] == list(range(w))


def test_compact_into_refuses_an_unaligned_x():
    inp = tmg.make_inputs(1, 2, 40, 8, seed=3)
    flat = torch.zeros(inp["x"].numel() + 1)
    x = flat[1:].view(inp["x"].shape)  # 4 bytes past a 16-byte boundary
    out = torch.empty((x.shape[0], x.shape[1], 8))
    with pytest.raises(ValueError, match="16-byte"):
        tmg._compact_into(out, "gather1", x, inp["idx"], 8)
