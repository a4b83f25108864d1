"""Roofline terms of an (arch x shape x mesh) cell (port of
``repro.launch.roofline``).

The peaks are one NVIDIA H100 SXM's (:class:`~repro_torch.core.
cost_model.H100Spec`): 989e12 FLOP/s for bf16 on the tensor cores
(dense) and 3.35e12 B/s of HBM3, in place of the JAX module's TPU v5e
constants.  Per cell, in seconds:

    compute    = flops / (chips * 989e12)
    memory     = bytes / (chips * 3.35e12)
    collective = collective bytes a card / link

The link (:func:`link_bw`) is NVLink's 450e9 B/s a direction for a mesh
of at most 8 cards (one NVLink domain, an HGX H100 node) and the
network's 50e9 B/s (one 400 Gb/s NIC a card) for a mesh that spans
nodes: the production 16 x 16 and 2 x 16 x 16 meshes take 50e9, as
JAX's ICI term took 50e9.  Both are data-sheet values, not measured.
The totals come from the dry-run (:mod:`repro_torch.launch.dryrun`):
flops and bytes a device counted on rank 0's local ops, collective
bytes from :mod:`repro_torch.launch.hlo_analysis`.

``MODEL_FLOPS`` uses the 6 N D (train) / 2 N D (inference) convention
with N the active parameters (a moe model counts its top-k routed and
shared experts only).  :func:`flash_attention_cost` is the attention
kernel's exact analytic footprint, which the dry-run adds to a step
whose attention is the ``"stub"`` backend.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import H100Spec

PEAK_FLOPS = H100Spec.tc_peak_flops   # bf16 FLOP/s per card (dense)
HBM_BW = H100Spec.hbm_bw              # bytes/s per card


def link_bw(chips: int) -> float:
    """Bytes/s a card sends a direction on a mesh of ``chips`` cards:
    NVLink within one domain, the network past it."""
    if chips <= H100Spec.nvlink_domain:
        return H100Spec.nvlink_bw
    return H100Spec.net_bw


@dataclasses.dataclass
class RooflineTerms:
    """One cell's totals and terms (seconds), as the JAX dataclass."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # global, extrapolated
    hlo_bytes: float          # global, extrapolated
    collective_bytes: float   # per-chip wire bytes, extrapolated
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: Optional[float] = None

    @property
    def dominant(self) -> str:
        """The largest term's name."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The roofline: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS over the compiled flops (remat and dispatch
        waste)."""
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline bound, against the
        card's bf16 peak."""
        return (self.model_flops / (self.chips * PEAK_FLOPS)
                / max(self.step_time_s, 1e-12))

    def to_dict(self) -> Dict:
        """Every field and derived term, JSON-able."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_ratio": self.useful_ratio, "mfu": self.mfu,
            "bytes_per_device": self.bytes_per_device,
        }


def active_params(cfg: ModelConfig) -> int:
    """Active parameter count (moe: top-k routed + shared + attention)."""
    total = cfg.param_count()
    if cfg.n_experts:
        ef = cfg.moe_d_ff or cfg.d_ff
        inactive = (cfg.n_experts - cfg.experts_per_token) * 3 \
            * cfg.d_model * ef * cfg.n_layers
        total -= inactive
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D for train, 2 N D for prefill, 2 N per row for decode (the
    attention over the cache is memory-bound and left out, as in JAX)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def make_terms(*, arch: str, shape: ShapeConfig, mesh_name: str,
               chips: int, hlo_flops_global: float,
               hlo_bytes_global: float, coll_bytes_per_chip: float,
               cfg: ModelConfig,
               bytes_per_device: Optional[float] = None) -> RooflineTerms:
    """The cell's :class:`RooflineTerms` from the dry-run's global flops
    and bytes and its collective bytes a card (JAX's ``make_terms`` on
    the H100's peaks and :func:`link_bw`)."""
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops_global, hlo_bytes=hlo_bytes_global,
        collective_bytes=coll_bytes_per_chip,
        model_flops=model_flops(cfg, shape),
        compute_s=hlo_flops_global / (chips * PEAK_FLOPS),
        memory_s=hlo_bytes_global / (chips * HBM_BW),
        collective_s=coll_bytes_per_chip / link_bw(chips),
        bytes_per_device=bytes_per_device,
    )


def extrapolate(f_a: float, f_b: float, l_a: int, l_b: int,
                l_full: int) -> float:
    """Linear extension ``f(L) = base + L * slope`` from two points."""
    slope = (f_b - f_a) / max(l_b - l_a, 1)
    base = f_a - l_a * slope
    return base + l_full * slope


# the flash backward recomputes the forward and reads Q, K, V, O, dO /
# writes dQ, dK, dV: a train step is ~3.5x the forward's flops and bytes
_TRAIN_FLOPS_FACTOR = 3.5
_TRAIN_BYTES_FACTOR = 3.5


def _one_attention_cost(batch: int, hq: int, hkv: int, seq: int, hd: int,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        elem_bytes: int = 2) -> Dict[str, float]:
    """(flops, bytes) of one attention layer's forward: the keys a query
    sees (a window, half the sequence causal, all of it otherwise) and
    Q + K + V + O once."""
    s_eff = min(window, seq) if window else (seq + 1) / 2 if causal else seq
    flops = 4.0 * batch * hq * seq * s_eff * hd
    bytes_ = elem_bytes * batch * seq * hd * (2 * hq + 2 * hkv)
    return {"flops": flops, "bytes": bytes_}


def flash_attention_cost(cfg: ModelConfig, shape: ShapeConfig
                         ) -> Dict[str, float]:
    """Global (flops, bytes) of all self-attention in one step, as the
    flash kernel does it: 0 for ssm; the hybrid's attention layers
    windowed once the sequence exceeds the window; the audio encoder
    (non-causal, ``encoder_seq``) and decoder, its cross-attention
    left out; times 3.5 for a train step."""
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    total = {"flops": 0.0, "bytes": 0.0}

    def add(n_layers, seq, window=None, causal=True):
        """Add ``n_layers`` layers of one attention shape."""
        c = _one_attention_cost(b, cfg.n_heads, cfg.n_kv_heads, seq, hd,
                                causal=causal, window=window)
        total["flops"] += n_layers * c["flops"]
        total["bytes"] += n_layers * c["bytes"]

    if cfg.family == "ssm":
        return total
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups = cfg.n_layers // len(pat)
        n_attn = (n_groups * sum(1 for k in pat if k == "attn")
                  + sum(1 for k in pat[:cfg.n_layers % len(pat)]
                        if k == "attn"))
        add(n_attn, s, window=cfg.local_window if s > cfg.local_window
            else None)
    elif cfg.family == "audio":
        add(cfg.encoder_layers, cfg.encoder_seq, causal=False)
        add(cfg.n_layers, s)
    else:
        add(cfg.n_layers, s)

    if shape.kind == "train":
        total["flops"] *= _TRAIN_FLOPS_FACTOR
        total["bytes"] *= _TRAIN_BYTES_FACTOR
    return total


__all__ = ["PEAK_FLOPS", "HBM_BW", "RooflineTerms", "active_params",
           "model_flops", "link_bw", "make_terms", "extrapolate",
           "flash_attention_cost"]
