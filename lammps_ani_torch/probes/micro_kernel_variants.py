"""Stripped radial-kernel variants on [nc, cap] x [nc, W] pair tiles: where
the cycles of the radial AEV kernel go (geometry, the cutoff and its two
exponentials, the 16-step recurrence, species-masked columns, masks
applied first, read-modify-write output).

Counterpart of examples/benchmark/micro_kernel_variants.py on the card.
`radial_variant` launches csrc/probes.cu's `probe_radial_variant<Stage>`,
one stage per Pallas body of the JAX probe; `radial_variant_plain` is the
plain PyTorch version. The JAX probe's production-kernel timing
(`run_grouped`) is micro_pieces.bare_kernel here: the port's radial
forward kernel (ops/aev_roll.radial_fwd, one candidate group) on the
coarse grid of the 15^3 water tile; `main` runs it after the stages.

    python -m lammps_ani_torch.probes.micro_kernel_variants
"""

from __future__ import annotations

import json
import math

import torch

from ._common import launch, route, time_ms

STAGES = ("geom_only", "geom_fc_exp", "recurrence16", "full32",
          "full32_premask", "full32_accum")
# output columns of each stage, and the columns its body writes (the first)
NCOL = {s: 16 if i < 3 else 32 for i, s in enumerate(STAGES)}
WRITTEN = {"geom_only": 1, "geom_fc_exp": 1, "recurrence16": 16,
           "full32": 32, "full32_premask": 32, "full32_accum": 32}

# Launch counts of the kernel by stage (one per launching wrapper call)
# and call counts of the plain version made by the wrapper (CPU tensors).
LAUNCHES = dict.fromkeys(STAGES, 0)
PLAIN_CALLS = dict.fromkeys(STAGES, 0)
_BODY_LINE = {"geom_only": 83, "geom_fc_exp": 88, "recurrence16": 97,
              "full32": 109, "full32_premask": 125, "full32_accum": 143}
REPLACES = {s: f"examples/benchmark/micro_kernel_variants.py:59 run_variant "
               f"(body v_{s} :{line})" for s, line in _BODY_LINE.items()}

# the JAX probe's main size: 6,864 rows (the coarse grid of the 15^3 water
# tile, padded to 8), 32 centers, a 27 x 32-lane window
MAIN = dict(nc=6864, cap=32, w=864)


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def make_inputs(nc, cap, w, seed=0, device=None, hi=120.0):
    """(px, py, pz [nc, cap], cx, cy, cz [nc, W] uniform on [0, hi), f32;
    cs [nc, W] int32 uniform on [-1, 4)), drawn from `seed`."""
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    u = [torch.rand(shape, generator=g, device=device) * hi
         for shape in [(nc, cap)] * 3 + [(nc, w)] * 3]
    cs = torch.randint(-1, 4, (nc, w), generator=g, device=device,
                       dtype=torch.int32)
    return (*u, cs)


def radial_variant(stage, px, py, pz, cx, cy, cz, cs):
    """[nc, cap, NCOL[stage]] (replaces the stage's Pallas body): the
    kernel for tensors on the card, the plain version on the CPU."""
    args = (px, py, pz, cx, cy, cz, cs)
    if not route(stage, PLAIN_CALLS, *args):
        return radial_variant_plain(stage, *args)
    nc, cap = px.shape
    w = cx.shape[1]
    ok = (all(t.shape == (nc, cap) and t.dtype == torch.float32
              for t in args[:3])
          and all(t.shape == (nc, w) and t.dtype == torch.float32
                  for t in args[3:6])
          and cs.shape == (nc, w) and cs.dtype == torch.int32)
    if not ok:
        shapes = [tuple(t.shape) for t in args]
        raise ValueError(f"radial_variant: inputs do not fit [nc, cap] x "
                         f"[nc, W] f32 / int32: {shapes}")
    if cap > 1024:
        raise ValueError(f"radial_variant: cap {cap} centers a row; the "
                         f"kernel's block of one thread a center takes at "
                         f"most 1024")
    out = px.new_zeros((nc, cap, NCOL[stage]))
    launch("probe_radial_variant",
           [nc, cap, w, NCOL[stage], STAGES.index(stage)], *args, out)
    LAUNCHES[stage] += 1
    return out


def radial_variant_plain(stage, px, py, pz, cx, cy, cz, cs, row_chunk=256):
    """The stage's Pallas body in PyTorch, over chunks of rows."""
    nc, cap = px.shape
    out = px.new_zeros((nc, cap, NCOL[stage]))
    for r0 in range(0, nc, row_chunk):
        rs = slice(r0, r0 + row_chunk)
        ax = px[rs][:, :, None] - cx[rs][:, None, :]
        ay = py[rs][:, :, None] - cy[rs][:, None, :]
        az = pz[rs][:, :, None] - cz[rs][:, None, :]
        d = torch.sqrt(torch.clamp(ax * ax + ay * ay + az * az, min=1e-12))
        o = out[rs]
        if stage == "geom_only":
            o[:, :, 0] = d.sum(-1)
            continue
        fc = torch.where(d <= 5.1,
                         0.5 * torch.cos(d * (math.pi / 5.1)) + 0.5, 0.0)
        x = torch.clamp(d, max=6.1) - 0.8
        t = 0.25 * fc * torch.exp(-19.7 * x * x)
        b = torch.exp(2.0 * 19.7 * 0.2867 * x)
        if stage == "geom_fc_exp":
            o[:, :, 0] = (t * b).sum(-1)
            continue
        if stage == "recurrence16":
            for k in range(16):
                if k:
                    t = t * b * 0.5
                o[:, :, k] = t.sum(-1)
            continue
        csv = cs[rs][:, None, :]
        if stage == "full32_premask":
            t0, t1 = t * (csv == 0), t * (csv == 3)
            bk = b * 0.5
            for k in range(16):
                if k:
                    t0, t1 = t0 * bk, t1 * bk
                o[:, :, 2 * k] = t0.sum(-1)
                o[:, :, 2 * k + 1] = t1.sum(-1)
            continue
        m0, m1 = (csv == 0).to(t.dtype), (csv == 3).to(t.dtype)
        for k in range(16):
            if k:
                t = t * b * 0.5
            o[:, :, 2 * k] = o[:, :, 2 * k] + (t * m0).sum(-1)
            o[:, :, 2 * k + 1] = o[:, :, 2 * k + 1] + (t * m1).sum(-1)
    return out


def variant_ops(stage, nc, cap, w, n_in=0, fused=True) -> dict:
    """Instructions of one call, a lower bound, split by the unit that
    runs them. "fp32": adds, multiplies, fused multiply-adds (one each),
    float compares, min and max; per pair the distance 9 (3 subtractions,
    3 products, 2 sums, the clamp: probes.cu rounds them as the plain
    version does), then geom_only 1 sum; the other stages the cutoff test
    1, x 2, t 4, b 1, and geom_fc_exp the sum of t b, recurrence16 15 x 2
    + 16 sums, full32 and full32_accum 15 x 2 + 32 masked sums,
    full32_premask 2 mask products, bk 1, 15 x 2 and 32 sums. With
    `fused` (the kernel's form) a masked sum is one fma(t, m, acc) and
    geom_fc_exp's term one fma(t, b, acc); without it each is a product
    and a sum: geom_fc_exp 19, full32 and full32_accum 111 instead of 18
    and 79. The cutoff's cosine
    and its 3 arithmetic instructions run only for the `n_in` pairs
    within 5.1 A (a branch); cosf without fast math is a polynomial on the
    fp32 unit, counted here as one instruction. "sfu": the sqrt
    (geom_only) and the two expf of the other stages, each at least one
    special-function instruction per pair. The species compares run on
    the integer unit and are not counted."""
    term = 1 if fused else 2  # a masked or weighted sum
    per = {"geom_only": 10, "geom_fc_exp": 17 + term,
           "recurrence16": 17 + 30 + 16, "full32": 17 + 30 + 32 * term,
           "full32_premask": 17 + 2 + 1 + 30 + 32,
           "full32_accum": 17 + 30 + 32 * term}[stage]
    pairs = nc * cap * w
    if stage == "geom_only":
        return {"fp32": per * pairs, "sfu": pairs}
    return {"fp32": per * pairs + 4 * n_in, "sfu": 3 * pairs}


def pairs_within(px, py, pz, cx, cy, cz, cutoff=5.1, row_chunk=256) -> int:
    """Pairs of the inputs whose distance (rounded as the kernel rounds
    it) is within `cutoff`: those that evaluate the cosine."""
    n = 0
    for r0 in range(0, px.shape[0], row_chunk):
        rs = slice(r0, r0 + row_chunk)
        ax = px[rs][:, :, None] - cx[rs][:, None, :]
        ay = py[rs][:, :, None] - cy[rs][:, None, :]
        az = pz[rs][:, :, None] - cz[rs][:, None, :]
        d = torch.sqrt(torch.clamp(ax * ax + ay * ay + az * az, min=1e-12))
        n += int((d <= cutoff).sum())
    return n


def variant_bytes(stage, nc, cap, w) -> int:
    """Bytes the function moves: centers, candidates and species in, the
    written columns out (f32 / int32)."""
    return 4 * (3 * nc * cap + 4 * nc * w + nc * cap * WRITTEN[stage])


def run_variant(stage, nc=MAIN["nc"], cap=MAIN["cap"], w=MAIN["w"], seed=0,
                reps=10, device="cuda") -> dict:
    """The stage's kernel at [nc, cap] x [nc, W] on the card: ms per call
    (CUDA events over `reps` calls after one warm call)."""
    args = make_inputs(nc, cap, w, seed=seed, device=device)
    ms = time_ms(lambda: radial_variant(stage, *args), reps=reps)
    return {"name": stage, "nc": nc, "cap": cap, "w": w,
            "slots": nc * cap * w, "ms": ms}


def main(argv=None) -> int:
    from . import micro_pieces

    for stage in STAGES:
        print(json.dumps(run_variant(stage)), flush=True)
    print(json.dumps({"name": "production radial_fwd ng=1",
                      **micro_pieces.bare_kernel()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
