"""DHP cost model — Eqs. (7)-(10) of the paper.

Memory  (Eq. 7):  M(C_p)  = sum_k A_kp |s_k| * M_token + M_ms
Compute (Eq. 8):  T_cp    = sum_k A_kp (a1 (1+eta_k) |s_k|^2 + a2 |s_k|) + b1
Comm    (Eq. 9):  T_cm    = (1/v_p) sum_k A_kp a3 |s_k| + b2
Total   (Eq.10):  T       = T_cp + T_cm - min(T_cpa, T_cma)

The per-rank execution time under CP degree d divides the compute terms
by d (ring CP splits the sequence evenly); the ring communication volume
per rank is ~|s|*(d-1)/d (each rank forwards its KV shard d-1 hops), which
the paper approximates as linear in |s| (Eq. 9 has no explicit d) — we
keep the exact (d-1)/d factor, which degenerates to the paper's form for
large d and to zero for d=1 (no ring needed), matching the paper's claim
that short sequences at low degree avoid redundant communication.

eta_k is the *mask efficiency factor*: the extra attention compute from
full-attention (vision) tokens relative to causal. eta=0 → pure causal,
eta=1 → pure full attention (2x the causal FLOPs).

eta is not an asserted scalar: multimodal sequences are described
structurally as `MMSequence`s of `ModalitySpan`s (a causal
text stream with bidirectional vision/audio blocks embedded in it —
the mask the paper's Eq. 8 actually costs), and eta is DERIVED from the
span geometry. With the causal half-mask folded into a1 (causal over
|s| tokens ~ |s|^2/2 score pairs), a bidirectional span of m tokens
adds m^2/2 extra pairs on top of its causal share, so

    eta = sum_b m_b^2 / |s|^2        over bidirectional spans b.

One span covering the whole sequence gives eta=1 (pure full attention);
no bidirectional spans give eta=0 (pure causal) — the two anchors of
the scalar model. `SeqInfo` is the planner currency: plain
`SeqInfo(length, eta)` construction works everywhere, and a span-bearing
`SeqInfo` recomputes its `length`/`eta` from the spans so structure is
the single source of truth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence as Seq, Tuple

import numpy as np

#: valid ModalitySpan.attn values
ATTN_CAUSAL = "causal"
ATTN_BIDIRECTIONAL = "bidirectional"


@dataclasses.dataclass(frozen=True)
class ModalitySpan:
    """A contiguous run of same-modality tokens inside one sequence.

    `start` is the token offset within the sequence; `attn` declares how
    the span's tokens attend *within the span*: "causal" (text) or
    "bidirectional" (vision frames / audio windows — the blocks that
    make Eq. 8's eta non-zero). Across spans the stream stays causal.
    """

    modality: str                   # "text" | "vision" | "audio" | ...
    start: int
    length: int
    attn: str = ATTN_CAUSAL

    def __post_init__(self):
        if self.length <= 0:
            raise ValueError(f"span length must be positive: {self}")
        if self.attn not in (ATTN_CAUSAL, ATTN_BIDIRECTIONAL):
            raise ValueError(f"unknown span attn {self.attn!r}")

    @property
    def end(self) -> int:
        return self.start + self.length

    def to_json(self) -> list:
        return [self.modality, self.start, self.length, self.attn]

    @classmethod
    def from_json(cls, obj) -> "ModalitySpan":
        return cls(modality=str(obj[0]), start=int(obj[1]),
                   length=int(obj[2]), attn=str(obj[3]))


def spans_length(spans: Seq[ModalitySpan]) -> int:
    return sum(s.length for s in spans)


def spans_eta(spans: Seq[ModalitySpan]) -> float:
    """Eq. 8's mask-efficiency factor derived from span geometry:
    sum of squared bidirectional-span lengths over squared total."""
    total = spans_length(spans)
    if total <= 0:
        return 0.0
    extra = sum(s.length ** 2 for s in spans
                if s.attn == ATTN_BIDIRECTIONAL)
    return extra / float(total) ** 2


def validate_spans(spans: Seq[ModalitySpan]) -> Tuple[ModalitySpan, ...]:
    """Sort + check the spans tile [0, total) contiguously."""
    out = tuple(sorted(spans, key=lambda s: s.start))
    off = 0
    for s in out:
        if s.start != off:
            raise ValueError(
                f"spans must tile the sequence contiguously from 0: "
                f"expected start {off}, got {s}")
        off = s.end
    return out


def slice_spans(spans: Seq[ModalitySpan], start: int,
                length: int) -> Tuple[ModalitySpan, ...]:
    """Clip a span layout to the window [start, start+length), re-based
    to 0 — how chunked prefill describes one chunk's structure."""
    end = start + length
    out = []
    for sp in sorted(spans, key=lambda s: s.start):
        a, b = max(sp.start, start), min(sp.end, end)
        if b > a:
            out.append(ModalitySpan(sp.modality, a - start, b - a,
                                    sp.attn))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SeqInfo:
    """One training sequence (text + vision tokens, already concatenated).

    `spans` (optional) is the structural description; when present,
    `length` and `eta` are RE-DERIVED from it at construction, so a
    span-bearing SeqInfo can never disagree with its own geometry.
    Plain `SeqInfo(length, eta)` remains the scalar fallback."""

    length: int              # total token count |s_k|
    eta: float = 0.0         # mask efficiency factor (Eq. 8)
    seq_id: int = -1         # stable id for assignment matrices
    spans: Optional[Tuple[ModalitySpan, ...]] = None

    def __post_init__(self):
        if self.spans:
            spans = validate_spans(self.spans)
            object.__setattr__(self, "spans", spans)
            object.__setattr__(self, "length", spans_length(spans))
            object.__setattr__(self, "eta", spans_eta(spans))

    @property
    def attn_weight(self) -> float:
        """(1 + eta) |s|^2 — the quadratic attention term."""
        return (1.0 + self.eta) * float(self.length) ** 2

    @property
    def linear_weight(self) -> float:
        return float(self.length)


@dataclasses.dataclass(frozen=True)
class MMSequence:
    """A multimodal sequence as its span structure, as the data pipeline
    draws it. The planner, packer and kernels consume its `SeqInfo`
    view (`.seq_info`), which carries the spans along and derives
    length and eta from them."""

    spans: Tuple[ModalitySpan, ...]
    seq_id: int = -1

    def __post_init__(self):
        object.__setattr__(self, "spans", validate_spans(self.spans))

    @property
    def length(self) -> int:
        return spans_length(self.spans)

    @property
    def eta(self) -> float:
        return spans_eta(self.spans)

    @property
    def seq_info(self) -> SeqInfo:
        return SeqInfo(length=0, eta=0.0, seq_id=self.seq_id,
                       spans=self.spans)


def as_seq_infos(seqs: Seq) -> list:
    """Normalize a batch that may mix MMSequence and SeqInfo."""
    return [s.seq_info if isinstance(s, MMSequence) else s for s in seqs]


@dataclasses.dataclass(frozen=True)
class CostCoeffs:
    """Profiled coefficients (seconds). See Profiler for how they are fit."""

    a1: float      # attention compute per (1+eta)|s|^2   [s / token^2]
    a2: float      # linear (MLP/QKV/...) compute per |s|  [s / token]
    b1: float      # per-microbatch fixed compute overhead [s]
    a3: float      # ring comm bytes->time per |s| at unit bandwidth [s*GBps/token]
    b2: float      # per-microbatch fixed comm overhead    [s]
    m_token: float # activation bytes per token (Eq. 7)    [bytes/token]
    m_ms: float    # model-state bytes per rank (ZeRO-3)   [bytes]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Bandwidth topology used for v_p in Eq. 9 (GB/s per link).

    The defaults are the reference package's analytic ones, kept so the
    port plans what it plans on the same coefficients; they are not the
    rates of any card's links. Give a cluster's own (an HGX H100 node's
    data sheet: NVLink 450 GB/s each way inside a node, InfiniBand NDR
    50 GB/s a GPU across nodes) where its plans should be priced."""

    intra_bw: float = 50.0    # link bandwidth inside a node
    inter_bw: float = 6.0     # link bandwidth across nodes
    ranks_per_node: int = 8   # ring spanning more than this uses inter_bw

    def ring_bandwidth(self, degree: int) -> float:
        """Bandwidth of the slowest link in a CP ring of `degree` ranks."""
        if degree <= 1:
            return float("inf")
        return self.intra_bw if degree <= self.ranks_per_node else self.inter_bw


class CostModel:
    """Evaluates Eqs. (7)-(10) for a set of sequences under CP degree d."""

    #: Bumped whenever the model's predictions may change (MeasuredCostModel
    #: increments it on every record()). Warm-started allocator states key
    #: on this so stale cost tables are never reused across model updates.
    cost_version: int = 0

    def __init__(self, coeffs: CostCoeffs, hw: Hardware | None = None):
        self.coeffs = coeffs
        self.hw = hw or Hardware()

    # ---- Eq. 7 -----------------------------------------------------------
    def memory(self, seqs: Seq[SeqInfo]) -> float:
        """Total activation+state bytes of a CP group (before / d split)."""
        c = self.coeffs
        return sum(s.length for s in seqs) * c.m_token + c.m_ms

    def min_degree(self, seqs: Seq[SeqInfo], budget: float) -> int:
        """d_min = ceil(M / (E * 1)) with per-rank budget E (Eq. 3)."""
        act = sum(s.length for s in seqs) * self.coeffs.m_token
        avail = budget - self.coeffs.m_ms
        if avail <= 0:
            raise ValueError(
                f"per-rank budget {budget:.3g} B cannot even hold model "
                f"states {self.coeffs.m_ms:.3g} B")
        import math
        return max(1, math.ceil(act / avail))

    # ---- Eq. 8 -----------------------------------------------------------
    def compute_time(self, seqs: Seq[SeqInfo], degree: int) -> float:
        c = self.coeffs
        attn = c.a1 * sum(s.attn_weight for s in seqs)
        lin = c.a2 * sum(s.linear_weight for s in seqs)
        return (attn + lin) / degree + c.b1

    def attn_compute_time(self, seqs: Seq[SeqInfo], degree: int) -> float:
        """T_cpa: only the attention part (the overlappable compute)."""
        return self.coeffs.a1 * sum(s.attn_weight for s in seqs) / degree

    # ---- Eq. 9 -----------------------------------------------------------
    def comm_time(self, seqs: Seq[SeqInfo], degree: int) -> float:
        if degree <= 1:
            return 0.0
        c = self.coeffs
        v = self.hw.ring_bandwidth(degree)
        vol = c.a3 * sum(s.length for s in seqs) * (degree - 1) / degree
        return vol / v + c.b2

    def attn_comm_time(self, seqs: Seq[SeqInfo], degree: int) -> float:
        """T_cma: the KV-ring traffic (all of Eq. 9's variable part)."""
        if degree <= 1:
            return 0.0
        c = self.coeffs
        v = self.hw.ring_bandwidth(degree)
        return c.a3 * sum(s.length for s in seqs) * (degree - 1) / degree / v

    # ---- Eq. 10 ----------------------------------------------------------
    def group_time(self, seqs: Seq[SeqInfo], degree: int) -> float:
        """Estimated wall time of one CP group executing its sequences."""
        if not seqs:
            return 0.0
        t_cp = self.compute_time(seqs, degree)
        t_cm = self.comm_time(seqs, degree)
        t_cpa = self.attn_compute_time(seqs, degree)
        t_cma = self.attn_comm_time(seqs, degree)
        return t_cp + t_cm - min(t_cpa, t_cma)

    def group_time_vector(self, seqs: Seq[SeqInfo],
                          degrees: np.ndarray) -> np.ndarray:
        """Eq. 10 for ONE group at MANY CP degrees in a single call.

        Bit-identical to ``[self.group_time(seqs, d) for d in degrees]``:
        the per-group aggregates (sum of attn/linear weights, token count)
        are reduced once with the same Python summation order the scalar
        path uses, after which every remaining operation is an elementwise
        float64 op whose IEEE semantics match the scalar expression
        exactly. The vectorized allocator certifies this equivalence in
        tests/test_allocator.py.
        """
        d = np.asarray(degrees, dtype=np.float64)
        if not seqs:
            return np.zeros(d.shape)
        c = self.coeffs
        # Aggregates, summed in the scalar path's order.
        attn = c.a1 * sum(s.attn_weight for s in seqs)
        lin = c.a2 * sum(s.linear_weight for s in seqs)
        toks = c.a3 * sum(s.length for s in seqs)
        t_cp = (attn + lin) / d + c.b1
        t_cpa = attn / d
        ring = np.where(d <= self.hw.ranks_per_node,
                        self.hw.intra_bw, self.hw.inter_bw)
        vol = toks * (d - 1.0) / d              # 0 at d=1, so no div issues
        t_cm = np.where(d <= 1.0, 0.0, vol / ring + c.b2)
        t_cma = np.where(d <= 1.0, 0.0, toks * (d - 1.0) / d / ring)
        return t_cp + t_cm - np.minimum(t_cpa, t_cma)

    def time_fn(self) -> Callable[[Seq[SeqInfo], int], float]:
        return self.group_time


def analytic_coeffs(
    *,
    hidden: int,
    n_layers: int,
    n_heads: int,
    kv_heads: int,
    ffn: int,
    vocab: int,
    dtype_bytes: int = 2,
    peak_flops: float = 197e12,     # the reference's analytic default
    mfu: float = 0.45,
    params: float | None = None,
    zero_shards: int = 64,
) -> CostCoeffs:
    """Roofline-derived coefficients for a transformer of the given shape.

    Used when no measured profile is available. `peak_flops` and `mfu`
    default to the reference package's analytic values, kept so that
    plans match it on identical coefficients; they are not a rate of the
    card. On the card the Profiler fits the compute terms (a1, a2, b1)
    from timed training groups instead. Training step FLOPs ~ 3x forward
    (fwd + 2x bwd).
    """
    head_dim = hidden // n_heads
    # attention: QK^T + AV = 2 * 2 * L^2 * hidden FLOPs per layer (causal
    # halves it; eta interpolates back up -> fold the 1/2 into a1).
    attn_flops_per_tok2 = 3 * 2 * 2 * hidden * n_layers * 0.5
    # linear: qkv + o + mlp (+ lm head amortized)
    lin_flops_per_tok = 3 * 2 * (
        hidden * (hidden + 2 * kv_heads * head_dim)  # qkv
        + hidden * hidden                             # out proj
        + 3 * hidden * ffn                            # swiglu mlp
    ) * n_layers + 3 * 2 * hidden * vocab
    eff = peak_flops * mfu
    n_params = params if params is not None else (
        n_layers * (hidden * (hidden + 2 * kv_heads * head_dim)
                    + hidden * hidden + 3 * hidden * ffn)
        + vocab * hidden)
    # activation bytes/token: per layer ~ (attn intermediates + mlp) in bf16,
    # with activation checkpointing keeping ~4*hidden + ffn per layer resident.
    m_token = dtype_bytes * n_layers * (4 * hidden + ffn) * 0.25
    # ZeRO-3: params+grads+optimizer(fp32 m,v,master) / shards
    m_ms = n_params * (2 + 2 + 12) / zero_shards
    # ring comm: 2 (K and V) * kv_heads*head_dim * bytes per token per hop
    a3 = 2 * kv_heads * head_dim * dtype_bytes / 1e9  # GB per token-hop
    return CostCoeffs(
        a1=attn_flops_per_tok2 / eff,
        a2=lin_flops_per_tok / eff,
        b1=2e-3,
        a3=a3,
        b2=1e-4,
        m_token=m_token,
        m_ms=m_ms,
    )
