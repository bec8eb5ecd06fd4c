"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell: the files under ``workloads/``,
``configs/``, ``traffic/`` and ``metrics/`` say what it runs and reads,
``traffic/generator.py`` makes its graph and ``reference/`` checks what
the timed path produced.  See ``README.md``.
"""
