"""repro_torch.analysis — static audits of the port's three hazard
surfaces (the counterpart of the reference's ``repro.analysis``):

* :mod:`repro_torch.analysis.trace_audit` — run one real step of every
  sweep variant (and the shared eval and the inference chunk) under a
  ``TorchDispatchMode`` and walk its aten ops for float64 outputs, cast
  round trips, host tables uploaded inside the step, process-group
  collectives and retrace instability, with the kernels' launches and
  the host syncs per step in each record.
* :mod:`repro_torch.analysis.kernel_audit` — the CUDA kernels' shared
  memory, registers and threads against the H100's limits, by formula
  and (on the card's machine) as built, bounds checks of the index
  tables the kernels gather by, and the pairing of the flash kernels'
  asynchronous pipelines (the event logs of their checked build, run on
  the card).
* :mod:`repro_torch.analysis.thread_audit` — AST concurrency lint over
  the thread-crossing modules (prefetch/engine/serving/featcache/
  inference/embedding_store): shared attributes written from two thread
  sides without lock/queue/ring discipline.

Run it with ``python -m repro_torch.analysis`` (``--device cpu`` on a
machine without a card); the intentional exceptions live in
``src/repro_torch/analysis/allowlist.toml``.
"""
from .findings import (GATING, Finding, apply_allowlist, as_json, gating,
                       load_allowlist, render_report)

__all__ = [
    "Finding", "GATING", "apply_allowlist", "as_json", "gating",
    "load_allowlist", "render_report",
]
