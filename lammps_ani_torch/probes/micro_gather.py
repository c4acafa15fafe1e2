"""Lane compaction strategies on window rows: an affine pass (the floor),
a gather of K of W lanes, three gathers, the decompaction back to W lanes,
and the one-hot sum that gives the gather's values by another strategy.

Counterpart of examples/benchmark/micro_gather.py on the card, at its two
cases. `compact` launches csrc/probes.cu's `probe_compact<Mode>`, one mode
per Pallas body of the JAX probe; `compact_plain` is the plain PyTorch
version; `library_call` is the one PyTorch call that computes the same
function (timed as a yardstick, used nowhere else). `compact_bytes` is
the byte bound; `compact_sector_bytes` the gathers' floor at the card's
32-byte sector grain and `onehot_steps` the one-hot strategy's work.

    python -m lammps_ani_torch.probes.micro_gather
"""

from __future__ import annotations

import json

import torch

from ._common import launch, route, time_ms

MODES = ("affine", "gather1", "gather3", "decompact", "onehot")
T_ROWS = 8  # rows of the TPU probe's blocks: nc = n_tiles * 8
# (n_tiles, cap, W, K): angular-like (W = 27 cap) and radial-like windows
CASES = ((1408, 20, 540, 32), (552, 28, 756, 96))

LAUNCHES = dict.fromkeys(MODES, 0)
PLAIN_CALLS = dict.fromkeys(MODES, 0)
_BODY = {"affine": "base_kernel :101", "gather1": "gather1_kernel :104",
         "gather3": "gather3_kernel :109",
         "decompact": "decompact_kernel :117", "onehot": "onehot_kernel :133"}
REPLACES = {m: f"examples/benchmark/micro_gather.py:92 run (body {b})"
            for m, b in _BODY.items()}


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def make_inputs(n_tiles, cap, w, k, seed=0, device=None):
    """x [nc, cap, W] normal f32, idx [nc, cap, 128] int32 on [0, W),
    widx [nc, cap, W] int32 on [0, 128), g = x[..., :K] (nc = 8 n_tiles),
    drawn from `seed`."""
    nc = n_tiles * T_ROWS
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    x = torch.randn((nc, cap, w), generator=gen, device=device)
    idx = torch.randint(0, w, (nc, cap, 128), generator=gen, device=device,
                        dtype=torch.int32)
    widx = torch.randint(0, 128, (nc, cap, w), generator=gen, device=device,
                         dtype=torch.int32)
    return dict(x=x, idx=idx, widx=widx, g=x[..., :k].contiguous(), k=k)


def _operands(mode, inp):
    """(data, index) of a mode: g and widx for the decompaction, x and idx
    otherwise."""
    if mode == "decompact":
        return inp["g"], inp["widx"]
    return inp["x"], inp["idx"]


def compact(mode, x, idx, k):
    """The mode's output (replaces its Pallas body): the kernel for tensors
    on the card, the plain version on the CPU. x [nc, cap, W] and idx
    [nc, cap, 128]; for "decompact" x is g [nc, cap, K] and idx widx
    [nc, cap, W]. An index outside its range gives 0."""
    if not route(mode, PLAIN_CALLS, x, idx):
        return compact_plain(mode, x, idx, k)
    nc, cap = x.shape[:2]
    w = idx.shape[2] if mode == "decompact" else x.shape[2]
    width = w if mode in ("affine", "decompact") else k
    return _compact_into(x.new_empty((nc, cap, width)), mode, x, idx, k)


def _compact_into(out, mode, x, idx, k):
    """Launches the mode's kernel into `out` [nc, cap, W or K], every entry
    of which it writes, and returns `out`. Raises a ValueError, before any
    launch, on what the kernel does not take: the ONEHOT kernel compares
    lanes as floats, exact below 2^24 lanes; the 16-byte loads need x and
    idx 16-byte aligned."""
    nc, cap = x.shape[:2]
    w = idx.shape[2] if mode == "decompact" else x.shape[2]
    ok = (x.dtype == torch.float32 and idx.dtype == torch.int32
          and 0 < k <= 128
          and (x.shape == (nc, cap, k) and idx.shape == (nc, cap, w)
               if mode == "decompact" else
               idx.shape == (nc, cap, 128)))
    if not ok:
        raise ValueError(f"compact({mode}): x {tuple(x.shape)} {x.dtype}, "
                         f"idx {tuple(idx.shape)} {idx.dtype}, K {k}")
    if mode == "onehot" and w >= 1 << 24:
        raise ValueError(f"compact(onehot): W {w} lanes; the kernel takes "
                         f"fewer than 2^24")
    if x.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError(f"compact({mode}): x and idx must start on a "
                         f"16-byte boundary")
    width = w if mode in ("affine", "decompact") else k
    if (out.shape != (nc, cap, width) or out.dtype != torch.float32
            or out.device != x.device):
        raise ValueError(f"compact({mode}): out {tuple(out.shape)} "
                         f"{out.dtype} {out.device}")
    launch("probe_compact", [nc, cap, w, k, MODES.index(mode)], x, idx, out)
    LAUNCHES[mode] += 1
    return out


def compact_plain(mode, x, idx, k):
    """The mode's Pallas body in PyTorch."""
    if mode == "affine":
        return x * 2.0 + 1.0
    if mode == "decompact":
        gpad = torch.nn.functional.pad(x, (0, 128 - k))
        return torch.gather(gpad, 2, idx.clamp(0, 127).long())
    sel = idx[..., :k].long()
    w = x.shape[2]
    inside = (sel >= 0) & (sel < w)

    def gather(v):
        # lanes outside [0, W) give 0, as the TPU's chunk gathers do
        return torch.where(inside, torch.gather(v, 2, sel.clamp(0, w - 1)),
                           0.0)

    if mode == "gather1":
        return gather(x)
    if mode == "gather3":
        acc = torch.zeros_like(x[..., :k])
        for c in range(3):
            acc = acc + gather(x + float(c))
        return acc
    lane = torch.arange(w, device=x.device)
    cols = [((lane == sel[..., a:a + 1]).to(x.dtype) * x).sum(-1)
            for a in range(k)]
    return torch.stack(cols, dim=-1)


def library_call(mode, inp):
    """The one PyTorch call that computes the mode's function (None where
    there is none): the affine pass's floor is a copy of the same bytes,
    gather1 and onehot are a gather, the decompaction a gather from g
    padded to 128 lanes. The index conversions happen here, untimed."""
    if mode == "affine":
        out = torch.empty_like(inp["x"])
        return lambda: out.copy_(inp["x"])
    if mode in ("gather1", "onehot"):
        sel = inp["idx"][..., :inp["k"]].long()
        return lambda: torch.gather(inp["x"], 2, sel)
    if mode == "decompact":
        gpad = torch.nn.functional.pad(inp["g"], (0, 128 - inp["k"]))
        widx = inp["widx"].long()
        return lambda: torch.gather(gpad, 2, widx)
    return None


def compact_bytes(mode, inp) -> int:
    """Bytes the function moves, each read or written once: the affine
    pass reads x and writes its image; a gather reads the first K index
    lanes and the distinct elements of x they name and writes [.., K];
    the decompaction reads widx and the distinct elements of g it names
    and writes [.., W]."""
    x, idx, widx, k = inp["x"], inp["idx"], inp["widx"], inp["k"]
    if mode == "affine":
        return 2 * x.numel() * 4
    if mode == "decompact":
        return (widx.numel() * 4 + _distinct(widx.clamp(max=k), k + 1, k)
                * 4 + widx.numel() * 4)
    sel = idx[..., :k]
    return sel.numel() * 4 + _distinct(sel, x.shape[2], x.shape[2]) * 4 \
        + sel.numel() * 4


def _distinct(sel, n_values, below) -> int:
    """Distinct values < `below` per row of `sel` (values in [0,
    n_values)), summed over rows."""
    rows = sel.reshape(-1, sel.shape[-1]).long()
    seen = torch.zeros((rows.shape[0], n_values), dtype=torch.bool,
                       device=rows.device)
    seen.scatter_(1, rows, True)
    return int(seen[:, :below].sum())


def compact_sector_bytes(inp) -> int:
    """Bytes a gather of the first K index lanes (gather1, gather3, onehot)
    moves at the card's 32-byte sector grain: every distinct sector of x
    that a row's in-range indices touch (x's rows laid end to end from a
    sector boundary, so a row of W = 540 lanes starts mid-sector every
    other row), counted once per row, plus the K index lanes read and the
    K outputs written. Out-of-range indices read nothing."""
    x, k = inp["x"], inp["k"]
    w = x.shape[2]
    sel = inp["idx"][..., :k].reshape(-1, k).long()
    rows = torch.arange(sel.shape[0], device=sel.device)[:, None]
    inside = (sel >= 0) & (sel < w)
    sector = torch.where(inside, torch.div(rows * w + sel, 8,
                                           rounding_mode="floor"), -1)
    srt = sector.sort(dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    sectors = int((first & (srt >= 0)).sum())
    return 32 * sectors + 2 * 4 * sel.numel()


def onehot_steps(inp) -> int:
    """Compare-and-fma steps of the one-hot strategy: every one of the K
    outputs of every row weighs every one of the row's W lanes, R K W."""
    nc, cap, w = inp["x"].shape
    return nc * cap * inp["k"] * w


def run(n_tiles, cap, w, k, reps=20, seed=0, device="cuda") -> dict:
    """Every mode's kernel at one case on the card: ms per call."""
    inp = make_inputs(n_tiles, cap, w, k, seed=seed, device=device)
    res = {"n_tiles": n_tiles, "cap": cap, "w": w, "k": k,
           "window_slots": n_tiles * T_ROWS * cap * w}
    for mode in MODES:
        x, idx = _operands(mode, inp)
        res[mode] = time_ms(lambda: compact(mode, x, idx, k), reps=reps)
    return res


def main(argv=None) -> int:
    for case in CASES:
        print(json.dumps(run(*case)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
