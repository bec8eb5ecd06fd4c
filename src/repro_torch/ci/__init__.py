"""The port's counterpart of the reference's ``make check``
(``scripts/ci.sh``): ``python -m repro_torch.ci`` runs its stages
(``__main__``); ``sweep_smoke`` and ``sweep_resume_smoke`` are the port's
``make sweep-smoke`` and ``scripts/sweep_resume_smoke.py``."""
