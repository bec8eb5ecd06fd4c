"""Configurations of the port: ``GNNConfig`` and ``ModelConfig`` with the
reference's fields (``repro.configs.base``), so the reference's config
modules copy unchanged, and the registry of every architecture the
reference has: the GNN and the dense, MoE, SSM, hybrid, audio and VLM
decoders."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Model configuration (the LM families; reference ``configs/base.py:19-116``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0                # query heads (0 for attn-free)
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- MLP ---
    mlp_act: str = "silu"           # "silu" (SwiGLU) | "gelu" (GeGLU)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # --- layer pattern ---
    # pattern tokens: "attn" (global), "local" (sliding window), "mamba",
    # "shared_attn" (zamba2-style weight-shared attention block).
    # None => ("attn",) * n_layers.
    layer_pattern: Optional[Tuple[str, ...]] = None
    sliding_window: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                # encoder frames (stub frontend output)
    # --- modality frontend stub (vlm) ---
    frontend_seq: int = 0           # patch embeddings prepended to the text
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True              # accepted for parity; serving ignores it
    tie_embeddings: bool = False
    # query chunk of the plain chunked attention (the flash kernel reads
    # neither chunk field: it tiles by itself and takes ragged S)
    q_chunk: int = 512
    kv_chunk: int = 1024
    moe_group: int = 256
    source: str = ""                # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            if len(self.layer_pattern) != self.n_layers:
                raise ValueError(
                    f"{self.name}: pattern length {len(self.layer_pattern)} "
                    f"!= n_layers {self.n_layers}")
            return self.layer_pattern
        return ("attn",) * self.n_layers

    @property
    def supports_long_decode(self) -> bool:
        """long_500k eligibility: SSM/hybrid, or dense with a sliding-window
        variant on some layers (reference ``configs/base.py:88-100``)."""
        toks = set(self.pattern)
        if "mamba" in toks:
            return True
        return "local" in toks and self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return True

    def validate(self) -> None:
        def req(cond: bool, msg: str) -> None:
            if not cond:
                raise ValueError(f"ModelConfig {self.name!r}: {msg}")
        req(self.d_model > 0 and self.n_layers > 0,
            "d_model and n_layers must be > 0")
        if self.family != "ssm":
            req(self.vocab_size > 0, "vocab_size must be > 0")
        for t in self.pattern:
            req(t in ("attn", "local", "mamba", "shared_attn"),
                f"unknown layer type {t!r}")
        if "local" in self.pattern:
            req(self.sliding_window > 0,
                "local layers need sliding_window > 0")

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
    # --- feature-table layout (the sharded sources' kernel path) ---
    # "replicated" | "sharded" (rows over the NODES shards with a
    # degree-ordered hot cache of feat_cache_rows rows: featshard.py for
    # the full-graph source and inference, an LRU model for the sampled
    # one).  The unsharded sources ignore both fields.
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
# Input shapes (reference ``configs/base.py:209-238``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    "train",   4_096,   256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  InputShape("decode_32k",  "decode",  32_768,  128),
    "long_500k":   InputShape("long_500k",   "decode",  524_288, 1),
}


def shape_applicable(cfg, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) should run, and why not if skipped."""
    if cfg.family == "gnn":
        return False, (
            "GNN configs use their own dry-run shapes (fullgraph_step / "
            "minibatch_step); see launch/dryrun.py")
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, (
            f"{cfg.name} is a pure full-attention stack; long_500k needs "
            "sub-quadratic attention (see DESIGN.md §Arch-applicability)")
    if shape.kind == "decode" and not cfg.has_decode:
        return False, f"{cfg.name} has no decode step"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_MODULES = ["gnn_papers100m", "gemma3_12b", "gemma_7b", "granite_3_2b",
                 "stablelm_1_6b", "internvl2_76b", "llama4_maverick_400b_a17b",
                 "llama4_scout_17b_a16e", "mamba2_130m", "whisper_medium",
                 "zamba2_7b"]

#: the reference's LM configurations
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


def get_config(name: str, smoke: bool = False
               ) -> Union[GNNConfig, ModelConfig]:
    """``full_config()`` (or ``smoke_config()``) of the named
    configuration, validated.  Accepts ``-`` or ``_`` spellings."""
    mods = _modules()
    for k, mod in mods.items():
        if k == name.replace("_", "-") or k.replace("-", "_") == name:
            cfg = mod.smoke_config() if smoke else mod.full_config()
            cfg.validate()
            return cfg
    raise KeyError(f"unknown arch {name!r}; have {sorted(mods)}")
