"""Config dataclasses for architectures and input shapes.

Every assigned architecture gets one module in this package defining a
``CONFIG`` constant; ``repro.configs.get_config(name)`` resolves it.  The
layer stack is described as ``pattern * n_rep + tail`` so the model code can
``lax.scan`` over pattern repetitions (compile time stays flat in depth).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One sublayer in the repeating pattern.

    kind:
      attn        - GQA attention + dense FFN block
      moe         - GQA attention + mixture-of-experts FFN block
      ssm         - Mamba2 (SSD) mixer block (no separate FFN)
      shared_attn - attention + FFN block whose params are SHARED across all
                    repetitions of the pattern (Zamba2-style)
    window: sliding-window size for attention (None = full/global attention)
    rope_base: RoPE theta for this sublayer (gemma3 uses 1M on globals)
    """

    kind: str = "attn"
    window: Optional[int] = None
    rope_base: float = 10_000.0

    def replace(self, **kw) -> "LayerSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | cnn
    source: str  # citation for the config (paper / model card)

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # layer schedule: pattern * n_rep + tail  (len == n_layers)
    pattern: Tuple[LayerSpec, ...] = ()
    n_rep: int = 0
    tail: Tuple[LayerSpec, ...] = ()

    # attention extras
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    use_qk_norm: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    router_groups: int = 1  # routing groups (set = data-axis size in prod)
    capacity_factor: float = 1.25
    moe_impl: str = "dense"  # dense (baseline) | dispatch (hillclimb)

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_scan_unroll: int = 1  # >1 unrolls the inter-chunk scan (exact
    #                           cost_analysis counting in the chunk study)

    # modality frontend (carve-out stubs)
    frontend: str = "none"  # none | vision_stub | audio_codebooks
    n_codebooks: int = 0  # musicgen
    n_patches: int = 0  # internvl vision token count
    d_vision: int = 0  # raw patch-embedding dim from the (stubbed) ViT

    # long-context behaviour for the long_500k decode shape
    # native: arch is sub-quadratic as-is (SSM / hybrid)
    # window: run the sliding-window variant (dense archs; documented)
    long_context_mode: str = "window"
    long_context_window: int = 4096

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # model-level kernel policy (DESIGN.md §9): which implementation the
    # model-zoo hot paths (rmsnorm, flash_gqa attention prefill/training)
    # run — "auto" (kernel on TPU, reference elsewhere) / "reference" /
    # "kernel" / "kernel_interpret".  Resolved host-side via
    # repro.kernels.dispatch.resolve_impl, so no runtime branch survives
    # jit.  CLI: --kernel-impl on launch/train.py, launch/serve.py and the
    # examples/ entry points.
    kernel_impl: str = "auto"

    # int8 KV cache (symmetric per-token-per-head quantisation) - halves
    # decode cache HBM; default-on for musicgen-large whose decode_32k
    # cache is 1.6 TB (EXPERIMENTS.md §Perf iteration 8)
    kv_quant: bool = False

    # per-arch train micro-batch (activation-memory knob; T = 256/mb
    # local-SGD iterations keeps the global batch fixed)
    train_micro_batch: int = 32

    # activation checkpointing for the train path: "block" remats every
    # sublayer (backward recomputes attention scores / FFN intermediates -
    # required to fit v5e HBM at train_4k; see EXPERIMENTS.md §Perf for the
    # no-remat ablation), "none" saves everything.
    remat: str = "block"

    # query-block size of the blockwise attention scan (memory/laxity
    # trade-off; the roofline calibration sets it to seq_len so the scan
    # has a single trip and cost_analysis counts it exactly).
    attn_q_block: int = 512

    # sequence (context) parallelism: pin the residual stream to
    # P("data", "model", None) - sequence sharded over the model axis,
    # layer weights replicated.  The hillclimb lever for few-head archs
    # (gemma3-1b: H=4, KV=1) where head/hd tensor parallelism forces
    # involuntary GSPMD resharding (EXPERIMENTS.md §Perf).  Only set by
    # the launch layer inside a mesh context.
    seq_shard: bool = False

    # CNN (paper-faithful ResNet runs)
    cnn_channels: Tuple[int, ...] = ()
    cnn_image_size: int = 32
    cnn_in_channels: int = 3
    n_classes: int = 0

    def __post_init__(self):
        if self.pattern or self.tail:
            total = len(self.pattern) * self.n_rep + len(self.tail)
            assert total == self.n_layers, (
                f"{self.name}: pattern*n_rep+tail = {total} != n_layers {self.n_layers}"
            )

    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        return tuple(self.pattern) * self.n_rep + tuple(self.tail)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 pattern reps, d_model<=256, <=4 experts.

        Keeps the *family structure* (same sublayer kinds) so smoke tests
        exercise the real code paths at CPU-friendly sizes.
        """
        d = min(self.d_model, 256) or 256
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = 64
        # compress the pattern to <=2 representative sublayers while keeping
        # every distinct sublayer kind (e.g. gemma3's 5xlocal+1xglobal ->
        # 1xlocal+1xglobal; zamba2's 5xssm+shared -> ssm+shared)
        seen, pat = set(), []
        for s in self.pattern:
            sig = (s.kind, s.window is None)
            if sig not in seen and len(pat) < 2:
                seen.add(sig)
                pat.append(s)
        pattern = tuple(pat)
        n_rep = 1 if pattern else 0
        tail = self.tail[: max(0, 2 - len(pattern) * n_rep)]
        n_layers = len(pattern) * n_rep + len(tail)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            pattern=pattern,
            n_rep=n_rep,
            tail=tail,
            dtype="float32",
        )
        if self.n_experts:
            kw.update(
                n_experts=min(self.n_experts, 4),
                top_k=min(self.top_k, 2),
                expert_ff=min(self.expert_ff, 128),
            )
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_chunk=32)
        if self.n_patches:
            kw.update(n_patches=8, d_vision=min(self.d_vision, 128))
        if self.cnn_channels:
            kw.update(cnn_channels=tuple(min(c, 16) for c in self.cnn_channels))
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def uniform_pattern(spec: LayerSpec, n_layers: int) -> dict:
    return dict(pattern=(spec,), n_rep=n_layers, tail=())
