"""Config dataclasses of the port: copies of the JAX package's
``ByzantineConfig`` and of the model-zoo specs (``AttentionSpec``,
``MoESpec``, ``SSMSpec``, ``RWKVSpec``, ``ModelConfig``) — the port
imports nothing of ``repro``.  ``tests/test_torch_models.py`` pins the
copies equal to the JAX dataclasses field by field.

``RecoveryConfig`` and ``TrainConfig`` are the train step's knobs
(``training/step.py``, ``faults/supervisor.py``, ``launch/train.py``).

``MoESpec`` is read by ``models/moe.py``, ``SSMSpec`` by
``models/mamba2.py``; ``InputShape`` is the assigned input shapes'
record (``configs/shapes.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ByzantineConfig:
    """Robust-aggregation config — the paper's technique knobs."""

    # any rule registered in core.engine: brsgd | mean | median |
    # trimmed_mean | krum | multi_krum | geomedian
    aggregator: str = "brsgd"
    beta: float = 0.5             # kept fraction (paper: beta = 1/2)
    threshold: float = 0.0        # 𝔗; 0.0 = auto (lower quartile of l1)
    trim_frac: float = 0.1        # trimmed_mean only
    krum_f: int = 0               # assumed byzantine count for krum; 0=auto
    # ------------------------------------------------------------------
    # threat model (training-time fault injection for experiments).
    # attack: "none" or any spec registered in core.threat.
    attack: str = "none"
    alpha: float = 0.0            # fraction of byzantine workers
    # membership policy — WHICH ⌊αm⌋ workers are byzantine:
    #   "prefix"   workers 0..⌊αm⌋-1 (the paper's arbitrary-identity set)
    #   "random"   fixed random subset drawn once from byz_seed
    #   "resample" fresh subset every step (drawn from the step key)
    membership: str = "prefix"
    byz_seed: int = 0             # membership="random" draw seed
    gaussian_std: float = 200.0   # gaussian: noise std (paper: 200)
    scale_factor: float = 1e10    # scale: multiplier on own gradient
    negation_factor: float = 1e10  # negation: c in -c * Σ honest
    alie_z: float = 1.5           # alie: z std-devs from honest mean
    ipm_eps: float = 0.5          # ipm: ε in -ε * mean(honest)
    # ------------------------------------------------------------------
    # elastic worker set (quorum aggregation).  0/0 = the classic fixed-m
    # bulk-synchronous round over every worker.
    max_m: int = 0
    quorum: int = 0

    def __post_init__(self):
        if self.max_m < 0 or self.quorum < 0:
            raise ValueError(
                f"max_m/quorum must be >= 0, got max_m={self.max_m} "
                f"quorum={self.quorum}")
        if self.max_m and self.quorum > self.max_m:
            raise ValueError(
                f"quorum={self.quorum} exceeds max_m={self.max_m} worker "
                f"slots")
        if self.quorum:
            # the adversary controls floor(alpha * n_active) of whichever
            # workers make the round, so the smallest round the config
            # permits must still hold an honest majority
            n_byz = int(self.alpha * self.quorum)
            if self.quorum <= 2 * n_byz:
                raise ValueError(
                    f"quorum={self.quorum} violates the honest-majority "
                    f"bound quorum > 2*n_byzantine: with alpha="
                    f"{self.alpha}, a {self.quorum}-worker round has "
                    f"n_byzantine = floor(alpha*quorum) = {n_byz} and "
                    f"2*{n_byz} >= {self.quorum} — robust selection over "
                    f"a possibly-byzantine-majority quorum is unsound; "
                    f"raise quorum or lower alpha")

    @property
    def elastic(self) -> bool:
        """True when this config opts into the elastic worker set
        (pad-to-max-m + validity mask + quorum select)."""
        return bool(self.max_m or self.quorum)


@dataclass(frozen=True)
class AttentionSpec:
    """Attention family description.

    kind:
      - "gqa": grouped-query attention (n_kv_heads <= n_heads)
      - "mla": multi-head latent attention (DeepSeek-V2 / MiniCPM3)
      - "none": attention-free layer stack (rwkv6)
    """

    kind: str = "gqa"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0               # sliding window (tokens); 0 = full
    # --- MLA-only fields ---
    q_lora_rank: int = 0          # 0 = full-rank q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0


@dataclass(frozen=True)
class MoESpec:
    n_experts: int = 0            # 0 = dense FFN
    top_k: int = 1
    n_shared: int = 0             # shared (always-on) experts
    d_ff_expert: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class SSMSpec:
    """Mamba2 (SSD) block spec."""

    state_dim: int = 64
    head_dim: int = 64
    n_heads: int = 0              # derived: d_inner // head_dim if 0
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class RWKVSpec:
    """RWKV6 ("Finch") block spec — data-dependent decay WKV."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    # 0 = per-token scan; Q > 0 = chunked-parallel WKV with Q-token
    # chunks (each chunk one launch of the WKV6 chunk kernel)
    chunk: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attention: AttentionSpec
    activation: str = "silu"      # silu | gelu | relu2 (squared relu)
    moe: MoESpec = field(default_factory=MoESpec)
    ssm: Optional[SSMSpec] = None
    rwkv: Optional[RWKVSpec] = None
    # hybrid layout: every ``hybrid_attn_every`` ssm layers, apply the
    # single SHARED attention block (zamba2 style).  0 = not hybrid.
    hybrid_attn_every: int = 0
    # moe layout: the first ``n_dense_layers`` layers use the dense FFN
    n_dense_layers: int = 0
    # modality frontend: "none" | "vision" | "audio"
    frontend: str = "none"
    n_prefix_tokens: int = 0      # patch/frame embedding count for vlm/audio
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"       # decode-cache dtype on the serve path
    source: str = ""              # citation

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (<=256 d_model,
        2 layers, <=4 experts, float32)."""
        att = self.attention
        d_model = min(self.d_model, 256)
        n_heads = min(att.n_heads, 4)
        n_kv = (min(att.n_kv_heads, max(1, n_heads // 2))
                if att.kind != "none" else 0)
        red_att = replace(
            att,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            head_dim=min(att.head_dim, 64),
            q_lora_rank=min(att.q_lora_rank, 64) if att.q_lora_rank else 0,
            kv_lora_rank=min(att.kv_lora_rank, 32) if att.kv_lora_rank else 0,
            qk_nope_dim=min(att.qk_nope_dim, 32) if att.qk_nope_dim else 0,
            qk_rope_dim=min(att.qk_rope_dim, 16) if att.qk_rope_dim else 0,
            v_head_dim=min(att.v_head_dim, 32) if att.v_head_dim else 0,
            window=min(att.window, 64) if att.window else 0,
        )
        moe = self.moe
        if self.is_moe:
            moe = replace(moe, n_experts=min(moe.n_experts, 4),
                          top_k=min(moe.top_k, 2),
                          n_shared=min(moe.n_shared, 1),
                          d_ff_expert=min(moe.d_ff_expert, 128))
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, state_dim=min(self.ssm.state_dim, 16),
                          head_dim=32, chunk=32)
        rwkv = None
        if self.rwkv is not None:
            rwkv = replace(self.rwkv, head_dim=32, decay_lora=16, mix_lora=8)
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 if self.hybrid_attn_every == 0 else 4,
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            attention=red_att,
            moe=moe,
            ssm=ssm,
            rwkv=rwkv,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class RecoveryConfig:
    """Fault-detection and self-healing knobs.

    ``guard`` puts the finite-gradient / loss-spike guard into the train
    step: a non-finite gnorm/loss or a loss above ``spike_mult``× the
    supervisor's EMA holds the update (params and optimizer state stay
    as they were), and a per-worker finiteness vector (``worker_ok``)
    rides out as a metric so the supervisor can evict the implicated
    workers from the validity mask.  The guard requires the elastic
    worker set (``ByzantineConfig.quorum/max_m``): eviction is a
    validity-mask edit.  Everything else here is host-side supervisor
    policy (faults/supervisor.py)."""

    guard: bool = False
    spike_mult: float = 10.0      # hold when loss > spike_mult * EMA
    ema_decay: float = 0.9        # loss EMA decay (host-side)
    evict_after: int = 1          # worker_ok strikes before eviction
    readmit_after: int = 8        # probation steps before re-admission
    rollback_after: int = 2       # consecutive held steps before rollback
    max_rollbacks: int = 3        # retry budget; exceeding it raises
    backoff_base: int = 2         # cooldown = base * 2^(rollbacks-1) steps
    keep_ckpts: int = 3           # keep-last-k retention (checkpoint/ckpt)

    def __post_init__(self):
        if self.spike_mult <= 1.0:
            raise ValueError(f"spike_mult must be > 1, got {self.spike_mult}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got "
                             f"{self.ema_decay}")
        for k in ("evict_after", "readmit_after", "rollback_after",
                  "backoff_base", "keep_ckpts"):
            if getattr(self, k) < 1:
                raise ValueError(f"{k} must be >= 1, got {getattr(self, k)}")
        if self.max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got "
                             f"{self.max_rollbacks}")


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    byzantine: ByzantineConfig = field(default_factory=ByzantineConfig)
    optimizer: str = "adamw"      # sgd | momentum | adamw
    lr: float = 3e-4
    momentum: float = 0.9
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0           # 0 = no grad accumulation
    remat: str = "none"           # none | block  (activation checkpointing)
    # fault detection / self-healing: recovery.guard puts the
    # finite-gradient + loss-spike hold into the step
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    # robust-aggregation execution strategy:
    #   scope  "global"  — the full per-worker gradient matrix G [m, D]
    #                      materialized, one global selection.
    #          "blocked" — per-layer-bucket aggregation inside the
    #                      backward (ROADMAP A.4; not ported yet).
    #          "auto"    — blocked iff param count > 20e9.
    agg_scope: str = "auto"
    #   layout "gather" / "a2a" / "auto" name the JAX package's
    #   collectives; one card holds all of G, so "gather" and "auto"
    #   both run the local executor and "a2a" waits for ROADMAP A.4.
    agg_layout: str = "auto"
