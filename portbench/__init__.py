"""The benchmark of ripor_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json and prints one JSON line.
Everything here is found by name: a configuration in ``configs/``, a
cell in ``workloads/``, a traffic driver in ``traffic/``, a per-layer
metric's reader in ``metrics/``. ``reference/`` is the plain model the
outputs are held against; ``counts.py`` the operations and bytes.
"""
