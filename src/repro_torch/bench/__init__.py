"""The paper's figure benches on the port (torch copies of the reference
``benchmarks/``): one module per figure or table, each with ``run(quick,
seed, env)``; ``python -m repro_torch.bench.run`` runs them all."""
