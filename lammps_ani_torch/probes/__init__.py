"""Card micro-benchmarks: the counterparts of the JAX package's Pallas
probes in examples/benchmark/ (micro_kernel_variants, micro_gather,
micro_pieces), one module each, with a `main()`:

    python -m lammps_ani_torch.probes.micro_kernel_variants
    python -m lammps_ani_torch.probes.micro_gather
    python -m lammps_ani_torch.probes.micro_pieces

The probe kernels are in csrc/probes.cu (built at first use by
ops/_build.py); each wrapper launches its kernel for tensors on the card
and runs its plain PyTorch version for tensors on the CPU. The timings
need the card.
"""
