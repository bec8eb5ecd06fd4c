"""Finding type + allowlist + report plumbing for ``repro_torch.analysis``
(a copy of the reference's ``repro.analysis.findings``).

Every checker (trace_audit / kernel_audit / thread_audit) emits a flat
list of ``Finding`` records; ``python -m repro_torch.analysis`` renders
them as a CLI report / JSON blob and exits nonzero when any *gating* finding
(severity "error" or "warning") survives the allowlist.  "info"
findings are report-only: deliberate lock-free handoffs and
known-unaliasable donations show up in the log without blocking CI.

The allowlist (``analysis/allowlist.toml``) is the explicit escape
hatch for findings that are intentional.  Entries match on
``checker`` + ``site`` prefix and MUST carry a ``reason`` — an entry
without one is itself reported as an error, so the file cannot silently
grow.  It is kept at <= 3 entries.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Sequence, Tuple

SEVERITIES = ("error", "warning", "info")

#: severities that make ``python -m repro_torch.analysis`` exit nonzero
GATING = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit.

    ``site`` is a stable dotted/paths-ish locator ("module.Class.attr",
    "kernel:limit:flash_attn[f32 D=256]", "variant:cluster+kernel") used
    both for human grep-ability and for allowlist prefix matching.
    """
    checker: str         # trace | kernel | thread
    severity: str        # error | warning | info
    site: str
    detail: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r} "
                             f"(expected one of {SEVERITIES})")

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.checker}:{self.severity}] {self.site}\n"
                f"    {self.detail}")


# ---------------------------------------------------------------------------
# Allowlist (a TOML subset, parsed by hand as the reference does: the
# narrow shape the file holds, [[allow]] tables of string keys)
# ---------------------------------------------------------------------------

def parse_allowlist(text: str) -> List[Dict[str, str]]:
    """Parse ``[[allow]]`` tables of ``key = "value"`` string pairs.

    Comments (whole-line or trailing ``#`` outside quotes) and blank
    lines are skipped.  Anything else is a hard error — the allowlist
    is a security-relevant config, not a place for silent parse drift.
    """
    entries: List[Dict[str, str]] = []
    cur: Dict[str, str] | None = None
    for ln, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line == "[[allow]]":
            cur = {}
            entries.append(cur)
            continue
        if "=" in line and cur is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            if not (len(val) >= 2 and val[0] == val[-1] == '"'):
                raise ValueError(
                    f"allowlist.toml:{ln}: value for {key!r} must be a "
                    f"double-quoted string, got {val!r}")
            cur[key] = val[1:-1]
            continue
        raise ValueError(f"allowlist.toml:{ln}: unparseable line {raw!r} "
                         "(only [[allow]] tables of string keys)")
    return entries


def _strip_comment(line: str) -> str:
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        if ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out)


def load_allowlist(path) -> Tuple[List[Dict[str, str]], List[Finding]]:
    """-> (entries, findings-about-the-allowlist-itself)."""
    import os
    bad: List[Finding] = []
    if not os.path.exists(path):
        return [], bad
    with open(path) as f:
        entries = parse_allowlist(f.read())
    for e in entries:
        missing = [k for k in ("checker", "site", "reason") if not e.get(k)]
        if missing:
            bad.append(Finding(
                "allowlist", "error", f"allowlist:{e.get('site', '?')}",
                f"entry is missing required keys {missing} — every "
                "allowlist entry must say what it matches and WHY"))
    return entries, bad


def apply_allowlist(findings: Sequence[Finding],
                    entries: Sequence[Dict[str, str]]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """-> (kept, suppressed).  An entry suppresses findings of its
    ``checker`` whose site starts with its ``site`` string."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if any(e.get("checker") == f.checker
               and f.site.startswith(e.get("site", "\0"))
               for e in entries):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


# ---------------------------------------------------------------------------
# Report rendering
# ---------------------------------------------------------------------------

def gating(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity in GATING]


def render_report(findings: Sequence[Finding],
                  suppressed: Sequence[Finding] = (),
                  extra: Dict | None = None) -> str:
    order = {s: i for i, s in enumerate(SEVERITIES)}
    lines: List[str] = []
    for f in sorted(findings, key=lambda f: (order[f.severity], f.checker,
                                             f.site)):
        lines.append(str(f))
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in SEVERITIES}
    lines.append(f"-- {counts['error']} error(s), "
                 f"{counts['warning']} warning(s), "
                 f"{counts['info']} info, "
                 f"{len(suppressed)} allowlisted")
    if extra:
        for k, v in extra.items():
            lines.append(f"-- {k}: {v}")
    return "\n".join(lines)


def as_json(findings: Sequence[Finding],
            suppressed: Sequence[Finding] = (),
            extra: Dict | None = None) -> str:
    return json.dumps({
        "findings": [f.as_dict() for f in findings],
        "suppressed": [f.as_dict() for f in suppressed],
        **(extra or {}),
    }, indent=1, sort_keys=True)
