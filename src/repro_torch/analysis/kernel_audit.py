"""CUDA kernel checker: Hopper resource budgets and index bounds (the
port's counterpart of ``repro.analysis.pallas_audit``).

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

The reference's fourth check ran its kernel's control paths on stubs;
its counterpart here would run each kernel under ``compute-sanitizer``,
which refuses the H100 of the machine the port is measured on ("Device
not supported"), so the port has none yet (ROADMAP).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

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
        "kBQ": 128, "kBK": 64, "kStages": 2, "kThreads": 384},
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
