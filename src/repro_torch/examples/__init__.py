"""The reference's ``examples/`` on the port, each run as a module::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.full_vs_minibatch
    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_smoke

Each takes the reference example's flags and defaults and prints what it
prints, plus ``--device`` (``cuda`` unless told otherwise; it raises on a
machine without a card).  The GNN examples and ``serve_batched`` also
take ``--kernel``: the aggregation through the CUDA kernels, and the
prefill's attention through the flash kernels.  Every ``main(argv)``
returns its exit code, so a caller can run an example in-process.
"""
