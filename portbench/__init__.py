"""The benchmark of the PyTorch/CUDA port, lammps_ani_torch.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card (run.py). It
imports neither JAX nor the JAX package; from the port it takes the
system under test (`Simulation` on the asn engine), its counters and its
kernels' names. Everything else is the benchmark's own: the traffic
generator (system.py, placement.py), the weights (weights.py), the
reference and the check (reference/, check.py), the trace's reading
(trace.py), the frozen counts (counts/) and one reader a per-layer metric
(metrics/).
"""
