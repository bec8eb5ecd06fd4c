"""GNN configuration for the port: ``GNNConfig`` with the reference's
fields and ``validate()`` (``repro.configs.base``), plus a GNN-only
registry.  The LM configurations come with the LM part of the port."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# GNN configuration (the paper's own system)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str = "gnn"
    model: str = "graphsage"        # gcn | graphsage | gat
    n_nodes: int = 0
    feat_dim: int = 0
    hidden: int = 256
    n_classes: int = 0
    n_layers: int = 2
    fanout: Tuple[int, ...] = (15, 10)   # β per hop (mini-batch)
    batch_size: int = 1024               # b (mini-batch)
    max_degree: int = 32                 # ELL padding for full-graph
    gat_heads: int = 4
    dtype: str = "float32"
    loss: str = "ce"                     # ce | mse
    # --- neighbor-aggregation kernel (kernels/neighbor_agg) ---
    # Routes the Ã-weighted aggregation of gcn/graphsage through the
    # hand-written CUDA gather kernel (on a CUDA tensor; its plain torch
    # version on a CPU tensor).  GAT keeps the einsum path (per-edge
    # softmax attention is not a weighted sum).
    use_agg_kernel: bool = False
    # Accepted and validated so one dict builds both packages' configs,
    # but the CUDA kernel reads none of them: it has no interpret mode,
    # and it masks ragged B/K/D edges itself instead of padding to tiles.
    agg_interpret: bool = True
    agg_b_tile: int = 8
    agg_d_tile: int = 128
    agg_k_slab: int = 4
    # --- feature-table layout (multi-device paths) ---
    # "replicated" | "sharded" (rows over the NODES axis with a hot cache
    # of feat_cache_rows rows).  Validated for parity with the reference;
    # the single-GPU port ignores both fields.
    feats_layout: str = "replicated"     # replicated | sharded
    feat_cache_rows: int = -1            # -1 auto (n//8) | 0 off | explicit C
    source: str = ""

    @property
    def has_decode(self) -> bool:
        return False

    def validate(self) -> None:
        """Reject bad (b, β) grids and kernel tilings up front — a zero
        tile or fan-out otherwise surfaces as an opaque shape
        error deep inside the aggregation kernel."""
        def req(cond: bool, msg: str) -> None:
            if not cond:
                raise ValueError(f"GNNConfig {self.name!r}: {msg}")
        req(self.model in ("gcn", "graphsage", "gat"),
            f"unknown model {self.model!r}")
        req(self.n_layers > 0, f"n_layers must be > 0, got {self.n_layers}")
        req(self.hidden > 0, f"hidden must be > 0, got {self.hidden}")
        req(len(self.fanout) == self.n_layers,
            f"fanout {self.fanout} must have one β per layer "
            f"(n_layers={self.n_layers})")
        req(all(int(b) > 0 for b in self.fanout),
            f"fan-outs must be positive, got {self.fanout}")
        req(self.batch_size > 0,
            f"batch_size must be > 0, got {self.batch_size}")
        req(self.n_nodes <= 0 or self.batch_size <= self.n_nodes,
            f"batch_size must not exceed the graph "
            f"(b={self.batch_size} > n_nodes={self.n_nodes}); the engine "
            f"pads b > n_train, but b > n can only be a grid typo")
        req(self.max_degree > 0,
            f"max_degree must be > 0, got {self.max_degree}")
        if self.model == "gat":
            req(self.gat_heads > 0,
                f"gat_heads must be > 0, got {self.gat_heads}")
        for f in ("agg_b_tile", "agg_d_tile", "agg_k_slab"):
            req(getattr(self, f) > 0,
                f"{f} must be > 0, got {getattr(self, f)}")
        req(self.feats_layout in ("replicated", "sharded"),
            f"unknown feats_layout {self.feats_layout!r} "
            f"(expected 'replicated' or 'sharded')")
        req(self.feat_cache_rows >= -1,
            f"feat_cache_rows must be -1 (auto), 0 (off) or a positive "
            f"cache size, got {self.feat_cache_rows}")


# ---------------------------------------------------------------------------
# Registry (GNN configurations only)
# ---------------------------------------------------------------------------

_ARCH_MODULES = ["gnn_papers100m"]

#: the reference's LM configurations; the LM family is ported in slice 6
LM_ARCHS = ("gemma3-12b", "gemma-7b", "granite-3-2b", "internvl2-76b",
            "llama4-maverick-400b-a17b", "llama4-scout-17b-a16e",
            "mamba2-130m", "stablelm-1.6b", "whisper-medium", "zamba2-7b")


def _modules() -> Dict[str, object]:
    mods = {}
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        mods[mod.full_config().name] = mod
    return mods


def list_archs() -> Tuple[str, ...]:
    return tuple(_modules())


def get_config(name: str, smoke: bool = False) -> GNNConfig:
    """``full_config()`` (or ``smoke_config()``) of the named GNN
    configuration, validated.  Accepts ``-`` or ``_`` spellings."""
    mods = _modules()
    for k, mod in mods.items():
        if k == name.replace("_", "-") or k.replace("-", "_") == name:
            cfg = mod.smoke_config() if smoke else mod.full_config()
            cfg.validate()
            return cfg
    raise KeyError(f"unknown arch {name!r}; have {sorted(mods)}")
