"""The yardstick's counts: work from positions, frozen per-unit tables.

`neighbors.py` counts a system's pairs from its positions alone (the
benchmark's own plain neighbor search); `asn_kernels.json` holds the
operations and bytes each of the asn kernels needs per unit of that work
(`asn_kernels.<config>.json`, where present, a configuration's own rows);
`groups.json` the kernel-name groups of the device trace; `work.py` turns
the counts into each kernel's bound and the step's counted FLOPs.
"""
