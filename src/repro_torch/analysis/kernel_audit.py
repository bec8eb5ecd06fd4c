"""CUDA kernel checker: Hopper resource budgets, index bounds and the
pairing of the asynchronous pipelines (the port's counterpart of
``repro.analysis.pallas_audit``).

The reference checked its Pallas kernels' VMEM working sets, the DMA /
semaphore pairing of their K-slab rotation, and the indices they gather
by.  The port's kernels (``kernels/*/csrc/*.cu``) are CUDA C++ for the
H100, where the scarce per-block resources are shared memory, registers
and threads, so the checks are:

1. **Budget by formula** (``default_budget_table``, CPU): one row per
   kernel and case, with the threads per block, the static and the
   dynamic shared memory its launch code asks for (``flash_attn.cu``'s
   ``Smem<float, D>::kBytes``, ``flash_attn_wgmma.cu``'s ``Cfg<D>::kSmem``; 0
   for the six neighbor-aggregation kernels), held to the H100's limits
   (``H100``).  Over a limit is an error; over ``WARN_FRACTION`` of it a
   warning, as in the reference.  The formulas read the launch constants
   in ``SOURCE_CONSTANTS``; ``audit_sources`` holds those named
   constants to the ``.cu`` files.  The layout arithmetic copied from
   ``kSmem`` (row padding, barriers, slack) is held to the build on the
   card instead (part 2).

2. **Resources as built** (``resource_usage`` / ``audit_resources``,
   card machine only: ``cuobjdump`` ships with the CUDA toolkit): each
   kernel symbol of the built libraries with its registers, static
   shared memory, local memory (spills) and stack, joined to its
   formula row.  Registers times threads must fit the SM's register
   file, the measured static shared memory must be what the formula
   says, and every symbol must have a formula row.  The dynamic shared
   memory each flash launch asks for (``kSmem`` at every head dim, read
   from the built library's ``SMEM_QUERIES``) must be what the formula
   says (``audit_launch_smem``).  ``parse_res_usage`` is a plain
   function of the tool's text, so tests feed it canned text.

3. **Index bounds** (``check_index_bounds`` / ``audit_index_tables``,
   CPU): the index tables the kernels gather by, built for a graph: the
   ELL ids, every featshard plan array against its target, the cluster
   source's batch blocks, and the reverse index of the full-graph
   backward (``ops.build_reverse_index``).

4. **Pipeline pairing** (``run_pipeline_check`` / ``check_pipeline_log``
   / ``audit_pipelines``; the reference's ``simulate_dma_pairing`` /
   ``_check_pane`` / ``audit_dma_pairing``, which ran its kernel body on
   stubs and logged every DMA start and wait).  The port's asynchronous
   pipelines are the two flash kernels': the ``wgmma`` kernel's TMA /
   mbarrier ring and the ``tf32x3`` kernel's ``cp.async`` groups.  A
   checked build of the same sources (``-DREPRO_PIPELINE_CHECK``,
   ``kernels/flash_attn/csrc/pipeline_check.cuh``; the library
   ``kernels.flash_attn.build.CHECKED``) runs on the card and logs every
   pipeline event; its ``mbar_wait`` gives up after a bound and logs a
   timeout, so a pairing fault is a finding and not a hung card.  The
   checker (pure Python, CPU) holds each block's log to the reference's
   four rules (no wait with nothing armed, no re-arm before the fill was
   consumed, a wait that matches its copy, nothing in flight at exit)
   and to the rules of the ring (TMA bytes equal to ``expect_tx``, the
   parity of every wait, arrivals before the producer's wait, reads
   after their wait, arrivals after the ``wgmma`` that read the stage
   retired) and of the ``cp.async`` groups (a read after its group's
   ``wait_group`` in every warp and a barrier; a refill after a barrier
   that follows every warp's last read of the old tile).  The model's
   stages, tiles and warps are the ``SOURCE_CONSTANTS`` the budget
   formulas use.  Each case's checked output must be bit-equal to the
   normal build's.  The ``pipeline`` fixture plants three faults
   (``analysis/fixtures_csrc/pipeline_faults.cu``).

What still waits is ``compute-sanitizer``'s memcheck (and racecheck) of
the neighbor kernels: the sanitizer on the card's machine refuses the
H100 ("Device not supported"; ROADMAP).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import dataclasses
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.analysis.findings import Finding

#: the H100's per-block and per-SM limits (bytes, registers, threads):
#: dynamic shared memory a block may opt into (227 KB), shared memory of
#: one SM (228 KB: a block's share plus the 1 KB the card reserves for
#: each resident block that uses shared memory), the SM's register file,
#: registers of one thread, threads of one block
H100 = {"smem_per_block": 232_448, "smem_per_sm": 233_472,
        "regs_per_sm": 65_536, "regs_per_thread": 255,
        "threads_per_block": 1_024}
#: shared memory the card reserves per resident block that uses any
#: (``cuobjdump``'s SHARED column counts it beside the static arrays)
SMEM_RESERVED = 1_024
#: registers are handed out per warp in units of 256: a thread's count is
#: rounded up to a multiple of 8
REG_GRANULE = 8
#: warn above this fraction of a limit, as the reference does
WARN_FRACTION = 0.75

#: the launch constants the formulas use, by source file (relative to the
#: ``repro_torch`` package), as ``constexpr int`` in that file
SOURCE_CONSTANTS = {
    "kernels/neighbor_agg/csrc/common.cuh": {"kWarp": 32},
    "kernels/neighbor_agg/csrc/neighbor_agg.cu": {"kRowsPerBlock": 8},
    "kernels/neighbor_agg/csrc/neighbor_agg_slab.cu": {"kWarpsPerBlock": 8},
    "kernels/neighbor_agg/csrc/neighbor_agg_bwd.cu": {"kRowsPerBlock": 8},
    "kernels/neighbor_agg/csrc/neighbor_agg_bwd_csr.cu": {
        "kRowsPerBlock": 8},
    "kernels/neighbor_agg/csrc/neighbor_agg_row.cu": {"kRowsPerBlock": 8},
    "kernels/flash_attn/csrc/flash_attn.cu": {
        "kBQ": 128, "kBK": 32, "kWideD": 256, "kBlocksPerSM": 2},
    "kernels/flash_attn/csrc/flash_attn_wgmma.cu": {
        "kBQ": 128, "kBK": 64, "kStages": 2, "kThreads": 384,
        "kConsumerWarps": 8},
    "analysis/fixtures_csrc/pipeline_faults.cu": {
        "kStages": 2, "kConsumerWarps": 2, "kBoxFloats": 512, "kBoxes": 2,
        "kCpThreads": 128, "kCpFloats": 1024},
}
#: kernels declared ``__launch_bounds__(kThreads, 1)``: one block per SM
ONE_BLOCK_PER_SM = ("flash_attn_wgmma_kernel",)
#: the head dims each flash kernel is compiled for
FLASH_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
#: each flash kernel's C query (in the flash library) of the dynamic
#: shared memory its launch asks for at a head dim
SMEM_QUERIES = {"flash_attn_kernel": "flash_attn_smem_bytes",
                "flash_attn_wgmma_kernel": "flash_attn_wgmma_smem_bytes"}


def _c(path: str, name: str) -> int:
    return SOURCE_CONSTANTS[path][name]


# ---------------------------------------------------------------------------
# Budgets by formula (mirroring each kernel's launch code)
# ---------------------------------------------------------------------------

def flash_tf32x3_tile(d: int) -> Dict[str, int]:
    """The launch shape of ``flash_attn.cu``'s ``flash_attn_kernel<T, D>``
    (``Tile<D>``): kBQ query rows a block and kBK keys a tile; a warp owns
    16 rows from head dim kWideD up and 32 (two m16 tiles) below it; the
    blocks its ``__launch_bounds__`` keeps resident on an SM (kBlocksPerSM
    below kWideD, one from it)."""
    src = "kernels/flash_attn/csrc/flash_attn.cu"
    wide = d >= _c(src, "kWideD")
    rows = _c(src, "kBQ")
    warps = rows // (16 if wide else 32)
    return {"rows": rows, "keys": _c(src, "kBK"), "threads": 32 * warps,
            "blocks": 1 if wide else _c(src, "kBlocksPerSM")}


def flash_tf32x3_smem(d: int) -> Dict[str, int]:
    """Dynamic shared memory of an f32 launch of ``flash_attn.cu``'s
    ``flash_attn_kernel<T, D>`` (``Smem<float, D>::kBytes``; bf16 tiles
    take half): the Q tile and one K and one V tile, rows padded by 16
    bytes (4 floats)."""
    tile = flash_tf32x3_tile(d)
    stride = d + 4
    return {f"Q tile [{tile['rows']}, {stride}] f32":
            4 * tile["rows"] * stride,
            f"K tile [{tile['keys']}, {stride}] f32":
            4 * tile["keys"] * stride,
            f"V tile [{tile['keys']}, {stride}] f32":
            4 * tile["keys"] * stride}


def flash_wgmma_smem(d: int) -> Dict[str, int]:
    """Dynamic shared memory of ``flash_attn_wgmma.cu``'s
    ``flash_attn_wgmma_kernel<D>`` (``Cfg<D>::kSmem``): two 64-row bf16 Q
    tiles and a ring of kStages K and V tiles, D padded to 64 columns,
    room for eight 8-byte mbarriers (seven are used) and 1 KB of slack
    to align the swizzled tiles."""
    src = "kernels/flash_attn/csrc/flash_attn_wgmma.cu"
    stages = _c(src, "kStages")
    tile = 64 * ((d + 63) // 64 * 64) * 2
    return {"Q tiles 2 x [64, D] bf16": 2 * tile,
            f"K ring {stages} x [64, D] bf16": stages * tile,
            f"V ring {stages} x [64, D] bf16": stages * tile,
            "mbarriers 8 x 8 B": 64, "alignment slack": 1024}


def budget_row(kernel: str, case: str, source: str, threads: int,
               dyn: Dict[str, int], head_dim: Optional[int] = None,
               blocks: Optional[int] = None) -> Dict:
    """One kernel case against the H100's limits.  ``dyn``: the dynamic
    shared memory's parts (no kernel of the port declares a static
    ``__shared__`` array: ``static_smem`` is 0, which the built symbols'
    SHARED column is held to).  ``blocks``: the blocks the launch bounds
    keep resident on an SM, whose shared memory and registers must fit it
    together (1 for the kernels of ``ONE_BLOCK_PER_SM``)."""
    smem = sum(dyn.values())
    uses = smem > 0
    if kernel in ONE_BLOCK_PER_SM:
        blocks = 1
    return {"kernel": kernel, "case": case, "source": source,
            "head_dim": head_dim, "threads": threads,
            "static_smem": 0, "dyn_smem": smem,
            "smem_bytes": smem, "smem_limit": H100["smem_per_block"],
            "smem_frac": round(smem / H100["smem_per_block"], 5),
            "smem_reserved": SMEM_RESERVED if uses else 0,
            "min_blocks_per_sm": blocks, "breakdown": dict(dyn)}


def default_budget_table() -> List[Dict]:
    """Every CUDA kernel and case the libraries are built with: the six
    neighbor-aggregation kernels (no shared memory; one row each covers
    all their dtype / width / epilogue instantiations) and the two flash
    kernels at each head dim they are compiled for."""
    na = "kernels/neighbor_agg/csrc/"
    warp = _c(na + "common.cuh", "kWarp")
    rows = [
        budget_row("neighbor_agg_kernel", "direct route, all dtypes",
                   na + "neighbor_agg.cu",
                   warp * _c(na + "neighbor_agg.cu", "kRowsPerBlock"), {}),
        budget_row("neighbor_agg_slab_kernel", "slab route, all widths",
                   na + "neighbor_agg_slab.cu",
                   warp * _c(na + "neighbor_agg_slab.cu", "kWarpsPerBlock"),
                   {}),
        budget_row("neighbor_agg_bwd_kernel", "atomic backward",
                   na + "neighbor_agg_bwd.cu",
                   warp * _c(na + "neighbor_agg_bwd.cu", "kRowsPerBlock"),
                   {}),
        budget_row("neighbor_agg_bwd_identity_kernel",
                   "identity-id backward", na + "neighbor_agg_bwd.cu",
                   warp * _c(na + "neighbor_agg_bwd.cu", "kRowsPerBlock"),
                   {}),
        budget_row("neighbor_agg_bwd_csr_kernel", "reverse-index backward",
                   na + "neighbor_agg_bwd_csr.cu",
                   warp * _c(na + "neighbor_agg_bwd_csr.cu",
                             "kRowsPerBlock"), {}),
        budget_row("neighbor_agg_row_kernel", "row kernel",
                   na + "neighbor_agg_row.cu",
                   warp * _c(na + "neighbor_agg_row.cu", "kRowsPerBlock"),
                   {}),
    ]
    fa = "kernels/flash_attn/csrc/"
    for d in FLASH_HEAD_DIMS:
        tile = flash_tf32x3_tile(d)
        rows.append(budget_row(
            "flash_attn_kernel", f"f32 tiles D={d}", fa + "flash_attn.cu",
            tile["threads"], flash_tf32x3_smem(d), head_dim=d,
            blocks=tile["blocks"]))
    for d in WGMMA_HEAD_DIMS:
        rows.append(budget_row(
            "flash_attn_wgmma_kernel", f"bf16 D={d}",
            fa + "flash_attn_wgmma.cu",
            _c(fa + "flash_attn_wgmma.cu", "kThreads"), flash_wgmma_smem(d),
            head_dim=d))
    return rows


def _site(check: str, row: Dict) -> str:
    return f"kernel:{check}:{row['kernel']}[{row['case']}]"


def _limit_findings(row: Dict, what: str, used: int, limit: int,
                    warn: bool = True) -> List[Finding]:
    """Over ``limit`` is an error (site ``kernel:limit:...``); over
    ``WARN_FRACTION`` of it a warning (``kernel:headroom:...``)."""
    if used > limit:
        return [Finding("kernel", "error", _site("limit", row),
                        f"{what} {used} exceeds the H100's {limit} "
                        f"({100 * used / limit:.1f}%) — the launch is "
                        f"refused")]
    if warn and used > WARN_FRACTION * limit:
        return [Finding("kernel", "warning", _site("headroom", row),
                        f"{what} {used} is {100 * used / limit:.1f}% of the "
                        f"H100's {limit} — no second block fits an SM")]
    return []


def audit_budgets(table: Optional[Sequence[Dict]] = None) -> List[Finding]:
    """Part 1: each formula row against the per-block and per-SM limits."""
    out: List[Finding] = []
    for row in (default_budget_table() if table is None else table):
        out += _limit_findings(row, "threads per block", row["threads"],
                               H100["threads_per_block"], warn=False)
        out += _limit_findings(row, "shared memory per block (B)",
                               row["smem_bytes"], H100["smem_per_block"])
        blocks = row["min_blocks_per_sm"] or 1
        out += _limit_findings(
            row, f"shared memory of {blocks} resident block(s) with the "
                 f"card's reserve (B)",
            blocks * (row["smem_bytes"] + row["smem_reserved"]),
            H100["smem_per_sm"], warn=False)
    return out


_CONSTEXPR = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;")
_BOUNDS = re.compile(r"__launch_bounds__\(\s*([^,()]+?)\s*(?:,\s*(\d+)\s*)?\)"
                     r"\s*(?://[^\n]*\n\s*)*(\w+)\s*\(")


def source_facts(text: str) -> Dict:
    """``constexpr int`` constants of a CUDA source and its kernels'
    ``__launch_bounds__`` minimum blocks per SM (``{kernel: n}``)."""
    consts = {m.group(1): int(m.group(2)) for m in _CONSTEXPR.finditer(text)}
    bounds = {m.group(3): int(m.group(2)) if m.group(2) else None
              for m in _BOUNDS.finditer(text)}
    return {"constants": consts, "min_blocks": bounds}


def audit_sources(root: Optional[str] = None) -> List[Finding]:
    """The formulas' constants and one-block-per-SM kernels against the
    ``.cu`` sources: a mismatch is an error (the table would be stale)."""
    from repro_torch.analysis.thread_audit import package_root
    root = root or package_root()
    out: List[Finding] = []
    one_block = set()
    for rel, want in SOURCE_CONSTANTS.items():
        with open(os.path.join(root, rel)) as f:
            facts = source_facts(f.read())
        for name, val in want.items():
            got = facts["constants"].get(name)
            if got != val:
                out.append(Finding(
                    "kernel", "error", f"kernel:source:{rel}:{name}",
                    f"the budget formula uses {name} = {val}, the source "
                    f"says {got}"))
        one_block |= {k for k, n in facts["min_blocks"].items() if n == 1}
    if one_block != set(ONE_BLOCK_PER_SM):
        out.append(Finding(
            "kernel", "error", "kernel:source:launch_bounds",
            f"kernels declared one block per SM: {sorted(one_block)}; the "
            f"table assumes {sorted(ONE_BLOCK_PER_SM)}"))
    return out


# ---------------------------------------------------------------------------
# Resources as built (cuobjdump -res-usage of each library)
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"^\s*Function\s+(\S+?):\s*$")
_FIELDS = re.compile(r"\b(REG|STACK|SHARED|LOCAL):(\d+)")


def parse_res_usage(text: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -res-usage`` text -> {mangled symbol: {"REG", "STACK",
    "SHARED", "LOCAL"}} (every ``Function`` line and the counts on the
    line after it)."""
    out: Dict[str, Dict[str, int]] = {}
    sym = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            sym = m.group(1)
            continue
        if sym is not None:
            fields = dict((k, int(v)) for k, v in _FIELDS.findall(line))
            if fields:
                out[sym] = fields
            sym = None
    return out


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found (neither on PATH nor at "
                       "/usr/local/cuda/bin): the resource audit reads the "
                       "built libraries with it")


def resource_usage(lib: str) -> Dict[str, Dict[str, int]]:
    """The resources of every kernel symbol in the built library ``lib``."""
    out = subprocess.run([_cuobjdump(), "-res-usage", lib],
                         capture_output=True, text=True, check=True)
    return parse_res_usage(out.stdout)


_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}


def symbol_kernel(sym: str, names: Sequence[str]):
    """-> (kernel name, template arguments) of a mangled kernel symbol, or
    (None, ()) for a symbol of none of ``names``.  Arguments decode the
    forms this repository's templates use: f32, bf16, ints, bools."""
    for name in sorted(names, key=len, reverse=True):
        tok = f"{len(name)}{name}"
        at = sym.find(tok)
        if at < 0:
            continue
        rest = sym[at + len(tok):]
        args = []
        if rest.startswith("I"):
            rest = rest[1:]
            while rest and rest[0] != "E":
                m = re.match(r"L[ib](\d+)E", rest)
                typ = next((t for t in _TYPES if rest.startswith(t)), None)
                if m:
                    args.append(int(m.group(1)))
                    rest = rest[m.end():]
                elif typ is not None:
                    args.append(_TYPES[typ])
                    rest = rest[len(typ):]
                else:
                    break
        return name, tuple(args)
    return None, ()


def _formula_row(kernel: str, args, table: Sequence[Dict]) -> Optional[Dict]:
    rows = [r for r in table if r["kernel"] == kernel]
    if rows and rows[0]["head_dim"] is not None:
        d = next((a for a in args if isinstance(a, int)), None)
        rows = [r for r in rows if r["head_dim"] == d]
    return rows[0] if len(rows) == 1 else None


def audit_resources(usage: Dict[str, Dict[str, int]],
                    table: Optional[Sequence[Dict]] = None):
    """Part 2: every built symbol joined to its formula row and held to
    the limits.  -> (findings, resource rows)."""
    table = default_budget_table() if table is None else table
    names = sorted({r["kernel"] for r in table})
    findings: List[Finding] = []
    rows: List[Dict] = []
    for sym, res in sorted(usage.items()):
        kernel, args = symbol_kernel(sym, names)
        frow = _formula_row(kernel, args, table) if kernel else None
        if frow is None:
            findings.append(Finding(
                "kernel", "error", f"kernel:symbol:{sym}",
                "a kernel symbol of the built library has no formula row "
                "— its budget is checked nowhere"))
            continue
        label = f"{kernel}<{','.join(map(str, args))}>"
        reg = res.get("REG", 0)
        regs_block = -(-reg // REG_GRANULE) * REG_GRANULE * frow["threads"]
        static = res.get("SHARED", 0)
        want_static = frow["static_smem"] + frow["smem_reserved"]
        blocks = frow["min_blocks_per_sm"] or 1
        row = {"symbol": label, "kernel": kernel, "case": frow["case"],
               "source": frow["source"], "head_dim": frow["head_dim"],
               "threads": frow["threads"],
               "reg": reg, "regs_per_block": regs_block,
               "shared_static": static, "shared_dynamic": frow["dyn_smem"],
               "local": res.get("LOCAL", 0), "stack": res.get("STACK", 0)}
        rows.append(row)
        srow = dict(frow, case=f"{frow['case']} {label}")
        findings += _limit_findings(srow, "registers per thread", reg,
                                    H100["regs_per_thread"], warn=False)
        findings += _limit_findings(
            srow, f"registers of {blocks} resident block(s) "
                  f"({reg} x {frow['threads']} threads)",
            blocks * regs_block, H100["regs_per_sm"])
        if static != want_static:
            findings.append(Finding(
                "kernel", "error", _site("static_smem", srow),
                f"measured static shared memory {static} B, the formula "
                f"says {frow['static_smem']} B + {frow['smem_reserved']} B "
                f"reserved"))
        findings += _limit_findings(
            srow, "static + dynamic shared memory per block (B)",
            static - frow["smem_reserved"] + frow["dyn_smem"],
            H100["smem_per_block"])
        findings += _limit_findings(
            srow, f"shared memory of {blocks} resident block(s) (B)",
            blocks * (static + frow["dyn_smem"]), H100["smem_per_sm"],
            warn=False)
        if row["local"]:
            findings.append(Finding(
                "kernel", "info", _site("spill", srow),
                f"{row['local']} B of local memory a thread (register "
                f"spills or a local array)"))
    return findings, rows


def built_libraries() -> Dict[str, str]:
    """{library name: path} of the port's kernel libraries, built from
    the checkout's sources if this digest's build does not exist yet."""
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attn import build as fa_build
    from repro_torch.kernels.neighbor_agg import build as na_build
    libs = [na_build.LIBRARY, fa_build.LIBRARY]
    return {lib.name: path for lib, path in zip(libs, build_all(libs))}


def audit_launch_smem(built: Dict, table: Optional[Sequence[Dict]] = None
                      ) -> List[Finding]:
    """Each flash row's formula against the dynamic shared memory the
    built launch asks for: ``built`` maps (kernel, head dim) to the
    bytes; a mismatch, or a row the build does not know, is an error."""
    table = default_budget_table() if table is None else table
    out: List[Finding] = []
    for row in table:
        if row["kernel"] not in SMEM_QUERIES:
            continue
        got = built.get((row["kernel"], row["head_dim"]), -1)
        if got != row["dyn_smem"]:
            out.append(Finding(
                "kernel", "error", _site("dyn_smem", row),
                f"the built launch asks for {got} B of dynamic shared "
                f"memory, the formula says {row['dyn_smem']} B"))
    return out


def launch_smem(lib) -> Dict:
    """{(kernel, head dim): bytes} of every flash launch, read from the
    loaded flash library ``lib`` (-1 where it is not built)."""
    dims = {"flash_attn_kernel": FLASH_HEAD_DIMS,
            "flash_attn_wgmma_kernel": WGMMA_HEAD_DIMS}
    return {(k, d): int(getattr(lib, fn)(d))
            for k, fn in SMEM_QUERIES.items() for d in dims[k]}


def audit_built() -> tuple:
    """Part 2 over both built libraries.  -> (findings, resource rows);
    a flash row carries ``shared_dynamic_built``, the bytes its launch
    asks for."""
    from repro_torch.kernels.flash_attn import build as fa_build
    usage: Dict[str, Dict[str, int]] = {}
    for path in built_libraries().values():
        usage.update(resource_usage(path))
    findings, rows = audit_resources(usage)
    built = launch_smem(fa_build.load_library())
    findings += audit_launch_smem(built)
    for r in rows:
        if r["kernel"] in SMEM_QUERIES:
            r["shared_dynamic_built"] = built[(r["kernel"], r["head_dim"])]
    return findings, rows


# ---------------------------------------------------------------------------
# Host-side index-table bounds (real data)
# ---------------------------------------------------------------------------

def check_index_bounds(idx, n_rows: int, site: str) -> List[Finding]:
    idx = np.asarray(idx)
    if idx.size == 0:
        return []
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= n_rows:
        return [Finding(
            "kernel", "error", site,
            f"index table range [{lo}, {hi}] escapes the operand's "
            f"[0, {n_rows}) rows — the kernel would read out of bounds")]
    return []


def check_reverse_index(rev, site: str = "bounds:reverse_index"
                        ) -> List[Finding]:
    """A reverse index (``ops.build_reverse_index``): ``indptr`` runs from
    0 to E without decreasing, and its edges address the ELL's B·K
    positions."""
    indptr = rev.indptr.cpu().numpy().astype(np.int64)
    out: List[Finding] = []
    e = rev.edges.numel()
    if indptr.size != rev.n + 1 or indptr[0] != 0 or indptr[-1] != e \
            or np.any(np.diff(indptr) < 0):
        out.append(Finding(
            "kernel", "error", f"{site}.indptr",
            f"indptr must run from 0 to E = {e} without decreasing over "
            f"{rev.n} + 1 entries; got {indptr.size} entries from "
            f"{int(indptr[0])} to {int(indptr[-1])}, min step "
            f"{int(np.diff(indptr).min()) if indptr.size > 1 else 0}"))
    out += check_index_bounds(rev.edges.cpu().numpy(), rev.b * rev.k,
                              f"{site}.edges")
    return out


def audit_index_tables(graph, mesh=None,
                       cache_rows: int = -1) -> List[Finding]:
    """Bounds-check the index tables the kernels consume for ``graph``:
    the ELL ids against the feature table, every featshard plan array
    against its target (``mesh``'s shard count; one shard when None, the
    mesh of a run on one device), the cluster source's batch blocks, and
    the reverse index of the full-graph ELL."""
    import torch

    from repro_torch import sharding as sh
    from repro_torch.core.graph import to_ell
    from repro_torch.core.partition import bfs_partition, cluster_ell_blocks
    from repro_torch.kernels.neighbor_agg.featshard import _plan_arrays
    from repro_torch.kernels.neighbor_agg.ops import build_reverse_index
    findings: List[Finding] = []
    idx, w, _ = to_ell(graph)
    findings += check_index_bounds(idx, graph.n, "bounds:ell.idx")
    s = 1 if mesh is None else sh.nodes_shards(mesh)
    pad = (-graph.n) % s
    idx_p = np.pad(idx, ((0, pad), (0, 0))) if pad else idx
    w_p = np.pad(w, ((0, pad), (0, 0))) if pad else w
    plan = _plan_arrays(idx_p, w_p, graph.degrees, s, cache_rows)
    n_loc, c, m, c_max = plan["n_loc"], plan["C"], plan["M"], plan["C_max"]
    checks = [
        ("bounds:featshard.lidx_hot", plan["lidx_hot"], c + n_loc),
        ("bounds:featshard.lidx_miss", plan["lidx_miss"], max(s * m, 1)),
        ("bounds:featshard.serve_loc", plan["serve_loc"], n_loc),
        ("bounds:featshard.hot_ids", plan["hot_ids"], graph.n),
        ("bounds:featshard.hot_src_loc", plan["hot_src_loc"], n_loc),
        ("bounds:featshard.hot_slot", plan["hot_slot"], max(c, 1)),
        ("bounds:featshard.hot_perm", plan["hot_perm"], max(s * c_max, 1)),
    ]
    for site, arr, n in checks:
        if arr is not None:
            findings += check_index_bounds(np.asarray(arr), n, site)
    # the cluster source's blocks: local ids within their cluster, so a
    # batch's block-diagonal union (offset by the running row count)
    # stays within its rows
    blocks = cluster_ell_blocks(graph, bfs_partition(
        graph, max(1, min(graph.n, 16)), seed=0))
    for ci, (bi, c_nodes) in enumerate(zip(blocks.idx, blocks.clusters)):
        findings += check_index_bounds(bi, len(c_nodes),
                                       f"bounds:cluster.block[{ci}]")
        findings += check_index_bounds(c_nodes, graph.n,
                                       f"bounds:cluster.nodes[{ci}]")
    rev = build_reverse_index(torch.as_tensor(idx), torch.as_tensor(w),
                              graph.n)
    findings += check_reverse_index(rev)
    return findings


# ---------------------------------------------------------------------------
# Pipeline pairing: the checked build's event logs
# ---------------------------------------------------------------------------

#: a log record's fields (``pipeline_check.cuh``)
PC_FIELDS = ("seq", "actor", "kind", "obj", "stage", "parity", "bytes",
             "tile")
#: the record kinds, in the order of ``pipeline_check.cuh``'s ``pc::Kind``
#: (codes from 1)
PC_KINDS = ("layout", "init", "expect_tx", "tma", "wait", "timeout",
            "arrive", "mma_commit", "mma_retire", "load", "commit",
            "wait_group", "sync", "read")
#: records a block of a checked launch (the largest case logs ~1,000)
PC_CAP = 4096
#: findings of one rule kept a block; the rest are counted in one line
PC_KEEP = 3
#: the pipeline check's sequence lengths (one key tile, the ring just
#: filled, the parity wrapped twice, ragged) and windows (0, and one that
#: makes the band skip tiles)
PIPELINE_LENGTHS = (64, 128, 320, 200)
PIPELINE_WINDOWS = (0, 96)
FLASH_SRC = "kernels/flash_attn/csrc/flash_attn.cu"
WGMMA_SRC = "kernels/flash_attn/csrc/flash_attn_wgmma.cu"
FAULTS_SRC = "analysis/fixtures_csrc/pipeline_faults.cu"


class PcEvent(NamedTuple):
    """One decoded log record (``PC_FIELDS``, the kind by name)."""
    seq: int
    actor: int
    kind: str
    obj: int
    stage: int
    parity: int
    bytes: int
    tile: int


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """What the checker holds a block's log to.  ``protocol`` "ring": an
    mbarrier ring of ``stages`` stages whose consumer warps are
    ``0 .. consumers - 1`` (any other warp is the producer); "cp_async":
    ``warps`` warps that load, commit, wait and read together.
    ``buffers`` name the three addresses of the block's layout record."""
    protocol: str
    stages: int = 0
    consumers: int = 0
    warps: int = 0
    buffers: tuple = ("Q", "K", "V")


def pipeline_spec(kernel: str, head_dim: int = 0) -> PipelineSpec:
    """The spec of ``kernel`` ("wgmma", "tf32x3", "fixture_ring",
    "fixture_cp_async") from ``SOURCE_CONSTANTS``."""
    if kernel == "wgmma":
        return PipelineSpec("ring", stages=_c(WGMMA_SRC, "kStages"),
                            consumers=_c(WGMMA_SRC, "kConsumerWarps"))
    if kernel == "tf32x3":
        return PipelineSpec(
            "cp_async", warps=flash_tf32x3_tile(head_dim)["threads"] // 32)
    if kernel == "fixture_ring":
        return PipelineSpec("ring", stages=_c(FAULTS_SRC, "kStages"),
                            consumers=_c(FAULTS_SRC, "kConsumerWarps"))
    if kernel == "fixture_cp_async":
        return PipelineSpec("cp_async",
                            warps=_c(FAULTS_SRC, "kCpThreads") // 32,
                            buffers=("buf0", "buf1", "-"))
    raise ValueError(f"no pipeline spec for kernel {kernel!r}")


def decode_pipeline_log(buf, cap: int) -> List[Dict]:
    """A checked launch's log (int32: blocks x (cap + 1) x 8, header
    first) -> one dict a block: ``block`` (its linear index), ``taken``
    (records it tried to log), ``overflow``, ``events`` (``PcEvent`` by
    seq) and ``torn`` (slots below ``taken`` that hold no record of
    theirs)."""
    n_f = len(PC_FIELDS)
    arr = np.asarray(buf, dtype=np.int32).reshape(-1, cap + 1, n_f)
    out = []
    for b, region in enumerate(arr):
        taken = int(region[0, 0])
        recs = region[1:1 + min(taken, cap)]
        ok = (recs[:, 0] == np.arange(len(recs))) & (recs[:, 2] >= 1) \
            & (recs[:, 2] <= len(PC_KINDS))
        events = [PcEvent(int(r[0]), int(r[1]), PC_KINDS[int(r[2]) - 1],
                          *(int(x) for x in r[3:]))
                  for r in recs[ok]]
        out.append({"block": b, "taken": taken,
                    "overflow": bool(region[0, 1]) or taken > cap,
                    "events": events,
                    "torn": [int(i) for i in np.flatnonzero(~ok)]})
    return out


class _Rules:
    """Findings of one block, at most ``PC_KEEP`` a rule."""

    def __init__(self, site: str):
        self.site = site
        self.kept: List[Finding] = []
        self.count: Dict[str, int] = {}

    def __call__(self, rule: str, detail: str) -> None:
        n = self.count.get(rule, 0)
        self.count[rule] = n + 1
        if n < PC_KEEP:
            self.kept.append(Finding("kernel", "error",
                                     f"{self.site}:{rule}", detail))

    def findings(self) -> List[Finding]:
        more = [f"{rule} {n - PC_KEEP}" for rule, n in self.count.items()
                if n > PC_KEEP]
        if more:
            return self.kept + [Finding(
                "kernel", "error", f"{self.site}:more",
                f"and more findings of the same rules: {', '.join(more)}")]
        return self.kept


def _layout(events, err) -> Optional[PcEvent]:
    layouts = [e for e in events if e.kind == "layout"]
    if len(layouts) != 1:
        err("layout", f"{len(layouts)} layout records (one expected): the "
                      f"log cannot name its barriers and buffers")
        return None
    return layouts[0]


_FULL_OF = {"Q": "q_full", "K": "full_k", "V": "full_v"}


def _check_ring(events: Sequence[PcEvent], spec: PipelineSpec, tiles,
                err) -> None:
    """The mbarrier ring of one block (``flash_attn_wgmma.cu``'s layout:
    full_k at barrier slot st, full_v at stages + st, empty at
    2 stages + st, q_full at 3 stages)."""
    lay = _layout(events, err)
    if lay is None:
        return
    n_st, n_c = spec.stages, spec.consumers
    bases = dict(zip(spec.buffers, (lay.obj, lay.stage, lay.parity)))
    bar0, tile_bytes = lay.bytes, lay.tile

    def barrier(addr):
        off = addr - bar0
        if off % 8 or not 0 <= off // 8 <= 3 * n_st:
            return None
        kind, st = divmod(off // 8, n_st)
        return ("full_k", "full_v", "empty", "q_full")[kind], st

    def buffer(addr):
        for name, base in bases.items():
            n = 2 if name == "Q" else n_st
            if base >= 0 and base <= addr < base + n * tile_bytes:
                return name, (addr - base) // tile_bytes
        return None

    def lab(b):
        return b[0] if b[0] == "q_full" else f"{b[0]}({b[1]})"

    init: Dict = {}
    fills: Dict = {}           # barrier -> [fill]
    arrivals: Dict = {}        # barrier -> [warp]
    waits: Dict = {}           # (warp, barrier) -> completed waits
    arrived: Dict = {}         # (warp, barrier) -> arrivals
    inflight: Dict = {}        # warp -> {(buffer, stage): ring tile}
    producers = set()
    unknown_init = set()
    for e in events:
        a, k = e.actor, e.kind
        if k in ("init", "expect_tx", "tma", "wait", "timeout", "arrive"):
            b = barrier(e.obj)
            if b is None:
                err("address", f"warp {a}'s {k} at shared address {e.obj} "
                               f"is no barrier of the layout")
                continue
            if k != "init" and b not in init and b not in unknown_init:
                unknown_init.add(b)
                err("init", f"{lab(b)} used ({k}, warp {a}) before its "
                            f"mbarrier.init")
        if k == "init":
            want = n_c if b[0] == "empty" else 1
            if b in init:
                err("init", f"{lab(b)} initialised twice")
            if e.bytes != want:
                err("init", f"{lab(b)} initialised for {e.bytes} arrivals; "
                            f"the ring needs {want}")
            init[b] = e.bytes
        elif k == "expect_tx":
            producers.add(a)
            f = len(fills.setdefault(b, []))
            if b[0] in ("full_k", "full_v"):
                emp = ("empty", b[1])
                need, got = f * n_c, len(arrivals.get(emp, []))
                if got < need:
                    err("rearm", f"{lab(b)} re-armed for fill {f} after "
                                 f"{got} of the {need} arrivals on "
                                 f"{lab(emp)} that free it: its copies "
                                 f"overwrite fill {f - 1} while a consumer "
                                 f"may still read it")
                w = waits.get((a, emp), 0)
                if w < f + 1:
                    err("dropped_wait",
                        f"{lab(b)} armed for fill {f} after {w} waits on "
                        f"{lab(emp)}: the producer waits on the stage's "
                        f"release before every fill (a dropped wait)")
            elif b[0] == "q_full" and f:
                err("rearm", f"q_full re-armed (fill {f}): Q is loaded once")
            elif b[0] == "empty":
                err("address", f"warp {a} arms an empty barrier with "
                               f"expect_tx")
            fills[b].append({"f": f, "expect": e.bytes, "tma": 0,
                             "boxes": 0, "waiters": set()})
        elif k == "tma":
            producers.add(a)
            if not fills.get(b):
                err("unarmed", f"TMA onto {lab(b)} with no expect_tx armed")
                continue
            fl = fills[b][-1]
            fl["tma"] += e.bytes
            fl["boxes"] += 1
            dst = buffer(e.stage)
            if dst is None or _FULL_OF.get(dst[0]) != b[0] or (
                    b[0] != "q_full" and dst[1] != b[1]):
                where = f"{dst[0]}[{dst[1]}]" if dst else f"address {e.stage}"
                err("descriptor", f"TMA into {where} completes on {lab(b)}: "
                                  f"the wait on {lab(b)} does not cover "
                                  f"that copy")
        elif k == "wait":
            n = waits.get((a, b), 0)
            waits[(a, b)] = n + 1
            if a < n_c:
                if b[0] == "empty":
                    err("role", f"consumer warp {a} waits on {lab(b)}")
                    continue
                if e.parity != (n & 1):
                    err("parity", f"warp {a}'s wait #{n} on {lab(b)} at "
                                  f"parity {e.parity}: fill {n} completes "
                                  f"the phase of parity {n & 1}")
                if n >= len(fills.get(b, [])):
                    err("unarmed", f"warp {a} passes its wait on {lab(b)} "
                                   f"fill {n} with nothing armed (on the "
                                   f"card it hangs or reads a stale phase)")
                    continue
                fl = fills[b][n]
                if fl["tma"] < fl["expect"]:
                    err("mismatch", f"warp {a}'s wait on {lab(b)} fill {n} "
                                    f"passed with {fl['tma']} of its "
                                    f"{fl['expect']} B issued: the wait does "
                                    f"not match its copy")
                fl["waiters"].add(a)
            elif b[0] == "empty":
                if e.parity != ((n & 1) ^ 1):
                    err("parity", f"the producer's wait #{n} on {lab(b)} at "
                                  f"parity {e.parity}: fill {n} of the stage "
                                  f"needs the phase of parity "
                                  f"{(n & 1) ^ 1}")
                need, got = n * n_c, len(arrivals.get(b, []))
                if got < need:
                    err("release", f"the producer's wait #{n} on {lab(b)} "
                                   f"passed after {got} of the {need} "
                                   f"arrivals it waits for")
        elif k == "timeout":
            err("timeout", f"warp {a}'s wait on {lab(b)} at parity "
                           f"{e.parity} timed out: the phase never "
                           f"completed (bytes or arrivals missing)")
        elif k == "arrive":
            if b[0] != "empty":
                err("role", f"warp {a} arrives on {lab(b)}")
                continue
            st = b[1]
            i = arrived.get((a, b), 0)
            arrived[(a, b)] = i + 1
            for fb in (("full_k", st), ("full_v", st)):
                if fills.get(fb) and waits.get((a, fb), 0) < i + 1:
                    err("early_arrive",
                        f"warp {a} arrives on {lab(b)} for fill {i} before "
                        f"its wait on {lab(fb)} fill {i}")
            for (buf, bst), it in inflight.get(a, {}).items():
                if bst == st and buf != "Q":
                    err("arrive_in_flight",
                        f"warp {a} arrives on {lab(b)} while its wgmma "
                        f"reading {buf}[{st}] (ring tile {it}) is in "
                        f"flight: the producer may refill the stage under "
                        f"it")
            arrivals.setdefault(b, []).append(a)
        elif k in ("mma_commit", "read"):
            src = buffer(e.obj)
            if src is None:
                err("address", f"warp {a} reads shared address {e.obj}, no "
                               f"stage of the layout")
                continue
            buf, st = src
            if buf != "Q":
                it, fb = e.tile, (_FULL_OF[buf], st)
                if st != it % n_st:
                    err("stage", f"warp {a} reads {buf}[{st}] at ring tile "
                                 f"{it}; the ring holds it in stage "
                                 f"{it % n_st}")
                f, n = it // n_st, waits.get((a, fb), 0)
                if n != f + 1:
                    err("read_before_wait",
                        f"warp {a} reads {buf}[{st}] (ring tile {it}, fill "
                        f"{f}) after {n} completed waits on {lab(fb)}: it "
                        f"reads only after its own wait on that fill")
            if e.stage >= 0:
                q = buffer(e.stage)
                if q is None or q[0] != "Q" or waits.get(
                        (a, ("q_full", 0)), 0) < 1:
                    err("read_before_wait", f"warp {a} reads Q before its "
                                            f"wait on q_full")
            if k == "mma_commit":
                inflight.setdefault(a, {})[src] = e.tile
        elif k == "mma_retire":
            if inflight.get(a, {}).pop(buffer(e.obj), None) is None:
                err("retire", f"warp {a} retires a wgmma on address {e.obj} "
                              f"it never committed")
        elif k != "layout":
            err("kind", f"a {k} record in a ring kernel's log")
    for a, groups in sorted(inflight.items()):
        for (buf, st), it in groups.items():
            err("in_flight", f"warp {a}'s wgmma reading {buf}[{st}] (ring "
                             f"tile {it}) never retired: in flight at block "
                             f"exit")
    for b, fls in sorted(fills.items()):
        for fl in fls:
            if fl["tma"] != fl["expect"]:
                err("bytes", f"{lab(b)} fill {fl['f']}: expect_tx "
                             f"{fl['expect']} B, TMA {fl['tma']} B in "
                             f"{fl['boxes']} boxes: " + (
                                 "the phase never completes"
                                 if fl["tma"] < fl["expect"] else
                                 "the phase completes before its last box "
                                 "lands"))
            missing = sorted(set(range(n_c)) - fl["waiters"])
            if missing:
                err("in_flight", f"{lab(b)} fill {fl['f']} was never waited "
                                 f"by warps {missing}: its copies are in "
                                 f"flight at block exit")
    for st in range(n_st):
        emp = ("empty", st)
        n_fill = len(fills.get(("full_k", st), fills.get(("full_v", st), [])))
        got = len(arrivals.get(emp, []))
        if (n_fill or emp in init) and got != n_c * n_fill:
            err("arrivals", f"{lab(emp)}: {got} arrivals at exit; "
                            f"{n_c} consumer warps x {n_fill} fills = "
                            f"{n_c * n_fill}")
    if tiles is not None:
        got = sum(len(fills.get(("full_k", st), [])) for st in range(n_st))
        if got != tiles:
            err("tiles", f"the producer filled {got} K tiles; the block's "
                         f"band needs {tiles}")
    if len(producers) > 1:
        err("role", f"warps {sorted(producers)} all produce: the ring has "
                    f"one producer")


def _check_cp_async(events: Sequence[PcEvent], spec: PipelineSpec, tiles,
                    err) -> None:
    """The cp.async groups of one block, modelled a warp at a time (lane
    0 of each warp logs; every thread of a warp issues the same copies,
    commits and waits)."""
    lay = _layout(events, err)
    if lay is None:
        return
    names = {addr: name for name, addr in zip(
        spec.buffers, (lay.obj, lay.stage, lay.parity)) if addr >= 0}
    per: Dict[int, Dict] = {}
    for e in events:
        w = per.setdefault(e.actor, {"nb": 0, "pending": [], "groups": [],
                                     "loads": [], "reads": [], "syncs": []})
        if e.kind == "load":
            ld = {"buf": names.get(e.obj, e.obj), "tile": e.tile,
                  "nb": w["nb"], "group": None}
            w["pending"].append(ld)
            w["loads"].append(ld)
        elif e.kind == "commit":
            for ld in w["pending"]:
                ld["group"] = len(w["groups"])
            w["groups"].append({"loads": w["pending"], "retired": None})
            w["pending"] = []
        elif e.kind == "wait_group":
            for g in w["groups"][:max(0, len(w["groups"]) - e.parity)]:
                if g["retired"] is None:
                    g["retired"] = w["nb"]  # the next barrier's number
        elif e.kind == "sync":
            w["syncs"].append((e.parity, e.tile))
            w["nb"] += 1
        elif e.kind == "read":
            w["reads"].append({"buf": names.get(e.obj, e.obj),
                               "tile": e.tile, "nb": w["nb"]})
        elif e.kind != "layout":
            err("kind", f"a {e.kind} record in a cp.async kernel's log")
    missing = sorted(set(range(spec.warps)) - set(per))
    if missing:
        err("warps", f"warps {missing} logged nothing")
    warps = sorted(per)
    if not warps:
        return
    ref = per[warps[0]]["syncs"]
    for a in warps[1:]:
        mine = per[a]["syncs"]
        if mine != ref:
            i = next((i for i, (x, y) in enumerate(zip(ref, mine)) if x != y),
                     min(len(ref), len(mine)))
            err("barrier", f"warps {warps[0]} and {a} part at barrier {i} "
                           f"({len(ref)} and {len(mine)} barriers; site, "
                           f"tile {ref[i:i + 1]} against {mine[i:i + 1]}): "
                           f"a __syncthreads not every warp reaches")
    for a in warps:
        got: Dict = {}
        for ld in per[a]["loads"]:
            got.setdefault(ld["buf"], []).append(ld["tile"])
        if tiles is not None and got != {k: list(v) for k, v in
                                         tiles.items()}:
            err("tiles", f"warp {a} loads {got}; the block's band needs "
                         f"{dict(tiles)}")
    loaded = {a: {(ld["buf"], ld["tile"]): ld for ld in per[a]["loads"]}
              for a in warps}
    for a in warps:
        for r in per[a]["reads"]:
            for v in warps:
                ld = loaded[v].get((r["buf"], r["tile"]))
                if ld is None:
                    err("read_unloaded", f"warp {a} reads {r['buf']} tile "
                                         f"{r['tile']}, which warp {v} "
                                         f"never loaded")
                    continue
                g = (per[v]["groups"][ld["group"]]
                     if ld["group"] is not None else None)
                if g is None or g["retired"] is None \
                        or g["retired"] >= r["nb"]:
                    when = ("never" if g is None or g["retired"] is None
                            else f"only before barrier {g['retired']}")
                    err("read_before_wait",
                        f"warp {a} reads {r['buf']} tile {r['tile']} after "
                        f"barrier {r['nb'] - 1}, but warp {v}'s copies of "
                        f"it are retired by a wait_group {when}: a read "
                        f"needs every warp's wait_group, then a barrier")
    for a in warps:
        prev: Dict = {}
        for ld in per[a]["loads"]:
            old = prev.get(ld["buf"])
            prev[ld["buf"]] = ld["tile"]
            if old is None:
                continue
            for v in warps:
                late = [r["nb"] for r in per[v]["reads"]
                        if (r["buf"], r["tile"]) == (ld["buf"], old)
                        and r["nb"] >= ld["nb"]]
                if late:
                    err("refill_race",
                        f"warp {a} refills {ld['buf']} with tile "
                        f"{ld['tile']} after barrier {ld['nb'] - 1}, but "
                        f"warp {v} reads its tile {old} after barrier "
                        f"{max(late) - 1}: no barrier between the last read "
                        f"and the refill (a write-after-read race)")
    for a in warps:
        for ld in per[a]["pending"]:
            err("in_flight", f"warp {a}'s copies of {ld['buf']} tile "
                             f"{ld['tile']} were never committed: in flight "
                             f"at block exit")
        for i, g in enumerate(per[a]["groups"]):
            if g["retired"] is None:
                what = ", ".join(f"{ld['buf']} tile {ld['tile']}"
                                 for ld in g["loads"])
                err("in_flight", f"warp {a}'s cp.async group {i} ({what}) "
                                 f"was never retired by a wait_group: in "
                                 f"flight at block exit")


def check_pipeline_log(blocks: Sequence[Dict], spec: PipelineSpec,
                       tiles: Optional[Callable[[int], object]] = None,
                       site: str = "kernel:pipeline") -> List[Finding]:
    """Hold each decoded block (``decode_pipeline_log``) to ``spec``'s
    rules.  ``tiles(block)`` gives what the block's band needs: the key
    tiles the ring fills (an int), or each buffer's tiles in load order
    (a dict); None skips that check.  A block whose log overflowed or
    tore is reported as such and not checked further."""
    out: List[Finding] = []
    for blk in blocks:
        err = _Rules(f"{site}:block{blk['block']}")
        if blk["overflow"]:
            err("overflow", f"the block's log is full ({blk['taken']} "
                            f"records asked for): the check would see a "
                            f"partial stream")
        elif blk["torn"]:
            err("torn", f"{len(blk['torn'])} log slots hold no record of "
                        f"theirs (first {blk['torn'][:4]})")
        elif not blk["events"]:
            err("empty", "the block logged nothing")
        else:
            events = sorted(blk["events"], key=lambda e: e.seq)
            want = tiles(blk["block"]) if tiles is not None else None
            check = _check_ring if spec.protocol == "ring" else \
                _check_cp_async
            check(events, spec, want, err)
        out += err.findings()
    return out


# ---------------------------------------------------------------------------
# Pipeline pairing on the card: the checked flash kernels
# ---------------------------------------------------------------------------

class PipelineCase(NamedTuple):
    """One checked launch: ``kernel`` "wgmma" or "tf32x3"; q [b, s, hq,
    d], k and v [b, s, hkv, d] in ``dtype`` (a torch dtype's name)."""
    kernel: str
    dtype: str
    d: int
    s: int
    window: int
    b: int = 1
    hq: int = 4
    hkv: int = 2

    @property
    def name(self) -> str:
        return (f"{self.kernel} {self.dtype} D={self.d} S={self.s} "
                f"window={self.window}")


def pipeline_cases() -> List[PipelineCase]:
    """The reference's warm-up, steady state and tail, for each kernel at
    every head dim class it serves: the ``wgmma`` kernel in bf16 (D = 64,
    112 in the zero-filled 128 layout, 256), the ``tf32x3`` kernel in f32
    (D = 16, 32, 64, 256: 256 is ``kWideD``, 8 warps), each at every
    ``PIPELINE_LENGTHS`` x ``PIPELINE_WINDOWS``, and the ``tf32x3``
    kernel once on bf16 inputs forced to its route."""
    from repro_torch.kernels.flash_attn.build import CHECKED_DIMS
    cases = [PipelineCase("wgmma", "bfloat16", d, s, w)
             for d in CHECKED_DIMS["PC_WGMMA_DIMS"]
             for s in PIPELINE_LENGTHS for w in PIPELINE_WINDOWS]
    cases += [PipelineCase("tf32x3", "float32", d, s, w)
              for d in CHECKED_DIMS["PC_F32_DIMS"]
              for s in PIPELINE_LENGTHS for w in PIPELINE_WINDOWS]
    cases += [PipelineCase("tf32x3", "bfloat16", d, max(PIPELINE_LENGTHS),
                           max(PIPELINE_WINDOWS))
              for d in CHECKED_DIMS["PC_BF16_DIMS"]]
    return cases


def pipeline_block_tiles(case: PipelineCase, block: int):
    """What block ``block`` (linear index; grid (hq, b, query tiles),
    the last query tile first) of ``case`` must load, by the kernel's
    band formula: the ring's key tiles (an int) or the ``tf32x3``
    kernel's Q, K and V tiles in load order."""
    src = WGMMA_SRC if case.kernel == "wgmma" else FLASH_SRC
    bq, bk = _c(src, "kBQ"), _c(src, "kBK")
    q_tiles = -(-case.s // bq)
    qi = q_tiles - 1 - block // (case.hq * case.b)
    q0 = qi * bq
    q_last = min(q0 + bq, case.s) - 1
    kt_lo = max(0, q0 - case.window + 1) // bk if case.window > 0 else 0
    kt_hi = q_last // bk
    if case.kernel == "wgmma":
        return kt_hi - kt_lo + 1
    keys = list(range(kt_lo, kt_hi + 1))
    return {"Q": [qi], "K": keys, "V": keys}


def pipeline_grid(case: PipelineCase) -> int:
    """Blocks of the case's launch (both kernels: hq x b x query tiles of
    kBQ rows)."""
    return case.hq * case.b * -(-case.s // _c(WGMMA_SRC, "kBQ"))


def check_case_log(case: PipelineCase, blocks: Sequence[Dict]
                   ) -> List[Finding]:
    """``check_pipeline_log`` of a flash case's decoded blocks, with the
    block tiles of its band."""
    return check_pipeline_log(
        blocks, pipeline_spec(case.kernel, case.d),
        tiles=lambda b: pipeline_block_tiles(case, b),
        site=f"kernel:pipeline:{case.kernel}[{case.name}]")


def run_pipeline_check(kernel: str, case: PipelineCase, device="cuda",
                       seed: int = 0, cap: int = PC_CAP) -> Dict:
    """One case on the card: the checked build logs every block of the
    launch, the checker holds the log, and the output must be bit-equal
    to the normal build's on the same inputs.  -> {"findings", "blocks",
    "events", "bit_equal", "checked_ms", "normal_ms", "log"}.  A launch
    that fails raises (no fallback)."""
    import math

    import torch

    from repro_torch.kernels.flash_attn import build as fb
    from repro_torch.kernels.flash_attn.ops import _DTYPE_CODE
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the pipeline check runs the checked build on the "
                         "card")
    if kernel != case.kernel:
        raise ValueError(f"case {case.name} is not a {kernel} case")
    lib, normal = fb.CHECKED.load(), fb.LIBRARY.load()
    if lib.pipeline_check_record_bytes() != 4 * len(PC_FIELDS):
        raise RuntimeError("the checked build's log records are not the "
                           "decoder's")
    dtype = getattr(torch, case.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(h):
        return torch.randn(case.b, case.s, h, case.d, generator=gen,
                           device=dev).to(dtype)

    q, k, v = rand(case.hq), rand(case.hkv), rand(case.hkv)
    n_blk = pipeline_grid(case)
    log = torch.zeros(n_blk * (cap + 1) * len(PC_FIELDS), dtype=torch.int32,
                      device=dev)
    outs = {"checked": torch.empty_like(q), "normal": torch.empty_like(q)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (case.b, case.s, case.hq, case.hkv, case.d, case.window,
             1.0 / math.sqrt(case.d), stream)

    def launch(which):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                outs[which].data_ptr())
        extra = (log.data_ptr(), cap) if which == "checked" else ()
        use = lib if which == "checked" else normal
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if kernel == "wgmma":
            err = use.flash_attn_wgmma_forward(*ptrs, *shape, *extra)
        else:
            err = use.flash_attn_forward(_DTYPE_CODE[dtype], *ptrs, *shape,
                                         *extra)
        end.record()
        if err != 0:
            raise RuntimeError(f"the {which} {kernel} launch of "
                               f"{case.name} failed with error {err}")
        end.synchronize()
        return start.elapsed_time(end)

    launch("normal")                      # warm: module load, attributes
    normal_ms = launch("normal")
    checked_ms = launch("checked")
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    bit_equal = torch.equal(outs["checked"].view(ints),
                            outs["normal"].view(ints))
    raw = log.cpu().numpy()
    blocks = decode_pipeline_log(raw, cap)
    findings = check_case_log(case, blocks)
    if not bit_equal:
        findings.append(Finding(
            "kernel", "error", f"kernel:pipeline:{kernel}[{case.name}]",
            "the checked build's output differs from the normal build's on "
            "the same inputs: its log may not describe the kernel that "
            "serves"))
    return {"case": case.name, "findings": findings, "blocks": n_blk,
            "events": sum(len(b["events"]) for b in blocks),
            "bit_equal": bool(bit_equal), "checked_ms": checked_ms,
            "normal_ms": normal_ms, "log": raw}


def audit_pipelines(cases: Optional[Sequence[PipelineCase]] = None,
                    device="cuda") -> tuple:
    """Part 4 on the card: build the checked library (timed), run every
    case of ``pipeline_cases()``.  -> (findings, summary): the summary
    has ``compile_s`` and, by kernel, the cases, blocks, events,
    findings, seconds, bit-equal cases and the checked and normal
    kernels' summed ms."""
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attn import build as fb
    t0 = time.perf_counter()
    build_all([fb.CHECKED])
    compile_s = time.perf_counter() - t0
    findings: List[Finding] = []
    kernels: Dict[str, Dict] = {}
    for case in (pipeline_cases() if cases is None else cases):
        t1 = time.perf_counter()
        r = run_pipeline_check(case.kernel, case, device)
        row = kernels.setdefault(case.kernel, {
            "cases": 0, "blocks": 0, "events": 0, "findings": 0,
            "seconds": 0.0, "bit_equal": 0, "checked_ms": 0.0,
            "normal_ms": 0.0})
        row["cases"] += 1
        row["blocks"] += r["blocks"]
        row["events"] += r["events"]
        row["findings"] += len(r["findings"])
        row["bit_equal"] += r["bit_equal"]
        row["checked_ms"] += r["checked_ms"]
        row["normal_ms"] += r["normal_ms"]
        row["seconds"] += time.perf_counter() - t1
        findings += r["findings"]
    return findings, {"compile_s": compile_s, "kernels": kernels,
                      "library": os.path.basename(fb.CHECKED.path())}


#: the flash cases whose logs ``tests/data/pipeline_logs.npz`` keeps
RECORDED_CASES = tuple(
    PipelineCase(kernel, dtype, 64, s, w)
    for kernel, dtype in (("wgmma", "bfloat16"), ("tf32x3", "float32"))
    for s in (64, 320) for w in (0, 96))


def checked_digest() -> str:
    """The digest in the checked library's file name (its sources,
    headers, flags and defines)."""
    from repro_torch.kernels.flash_attn import build as fb
    return os.path.basename(fb.CHECKED.path()).rsplit("_", 1)[1][:-3]


def record_pipeline_logs(path: str, device="cuda") -> Dict:
    """Run ``RECORDED_CASES`` on the card and write two blocks of each
    (the heaviest query tile of heads 0 and 1 at one query tile, else of
    head 0 and the first query tile) to ``path`` (npz: ``log<i>``, each
    cut to its longest block, and ``meta``, a JSON list of each log's
    case, blocks, cap and the checked build's digest)."""
    arrays, meta = {}, []
    for i, case in enumerate(RECORDED_CASES):
        r = run_pipeline_check(case.kernel, case, device)
        if r["findings"]:
            raise RuntimeError(f"{case.name}: findings in a log to keep: "
                               f"{[str(f) for f in r['findings']]}")
        n_blk = pipeline_grid(case)
        keep = [0, 1] if n_blk == case.hq * case.b else [0, n_blk - 1]
        regions = r["log"].reshape(n_blk, PC_CAP + 1, len(PC_FIELDS))[keep]
        cap = int(regions[:, 0, 0].max())
        arrays[f"log{i}"] = np.ascontiguousarray(regions[:, :cap + 1])
        meta.append({"case": case._asdict(), "blocks": keep, "cap": cap,
                     "digest": checked_digest()})
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)
    return {"path": path, "logs": len(meta), "digest": checked_digest()}


def load_pipeline_logs(path: str) -> List[Dict]:
    """``record_pipeline_logs``'s file -> one dict a log: ``case``
    (``PipelineCase``), ``blocks`` (decoded, renumbered to the launch's
    linear block indices), ``digest``."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        out = []
        for i, m in enumerate(meta):
            blocks = decode_pipeline_log(z[f"log{i}"], m["cap"])
            for blk, b in zip(blocks, m["blocks"]):
                blk["block"] = b
            out.append({"case": PipelineCase(**m["case"]), "blocks": blocks,
                        "digest": m["digest"]})
    return out
