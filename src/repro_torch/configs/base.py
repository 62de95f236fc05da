"""Config system for the port: the recurrent stack config, the model
config, the shape and training configs, copied from
``repro.configs.base`` (the port imports nothing of ``repro``). One
config type serves the cell families (the GRU and the sLSTM) and the
transformer LMs, dense (``qwen3-0.6b``, ``qwen2.5-3b``, ``phi4-mini-3.8b``,
``command-r-35b``) and mixture-of-experts (``qwen2-moe-a2.7b``,
``qwen3-moe-235b-a22b``, through :class:`MoEConfig`) and the recurrent
LMs, the xLSTM (``xlstm-125m``, family ``"ssm"``, through
:class:`XLSTMConfig`) and hymba (``hymba-1.5b``, family ``"hybrid"``,
attention and Mamba heads in parallel, through :class:`SSMConfig`), the
encoder-decoder (``whisper-large-v3``, family ``"audio"``, through
:class:`EncoderConfig`) and the vision-language model
(``llava-next-mistral-7b``, family ``"vlm"``, through
:class:`VisionStubConfig`): every config of the JAX package.

Backend preferences are the port's names (see ``repro_torch.core.runtime``):
``"eager"`` (default, the JAX ``"xla"``), ``"cuda"`` (the JAX ``"pallas"``),
an exact backend name such as ``"cuda_fused"`` or ``"cuda_fused_q8"``, or
``"auto"``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    shared_d_ff: int = 0             # 0 = no shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001   # load-balance aux loss
    norm_topk_prob: bool = True      # renormalize top-k weights (qwen3 style)
    tp_mode: str = "gather"          # expert TP under a mesh: "gather" |
                                     # "psum" (the mesh path is not ported)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hymba's parallel SSM heads)."""
    state_dim: int = 16
    conv_width: int = 4
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)
    expand: int = 1                  # inner expansion of the ssm path


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_layers: Tuple[int, ...] = ()   # layer indices that are sLSTM blocks
    proj_factor: float = 2.0             # mLSTM up-projection factor
    conv_width: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). Frontend is a stub:
    input_specs() provides precomputed frame embeddings."""
    num_layers: int
    num_frames: int = 1500           # whisper: 30 s of audio after conv frontend


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM modality frontend stub: precomputed patch embeddings are inputs."""
    num_patches: int = 576           # base-resolution tile (anyres tiles stubbed)
    embed_dim: int = 1024            # pre-projection CLIP dim


@dataclass(frozen=True)
class GRUConfig:
    """A depth-L recurrent stack: the paper's GRU, or another cell family.

    Layer 0 consumes ``input_dim``; layer ``l`` consumes the previous
    layer's hidden size. ``layer_matvec_modes`` optionally overrides
    ``matvec_mode`` per layer (GRU). ``family`` names the cell recurrence
    (``repro_torch.core.cells``): ``"gru"`` or ``"slstm"``.
    """
    input_dim: int = 5
    hidden_dim: int = 20
    num_classes: int = 5
    matvec_mode: str = "rowwise"     # "rowwise" | "cascade" | "dense"
    fused_gates: bool = True         # hybrid fused aggregation vs unfused
    decoupled_wx: bool = True        # hoist W.x out of the recurrence
    variant: str = "v1"              # "v1" (paper/Cho) | "v3" (fused-U)
    backend: str = "eager"           # "eager" | "cuda" | "auto" | exact name
    row_block: int = 0               # rows per block (0 = auto)
    num_layers: int = 1              # stack depth (ignored if layer_dims set)
    layer_dims: Tuple[int, ...] = ()     # per-layer hidden sizes; () -> uniform
    layer_matvec_modes: Tuple[str, ...] = ()  # per-layer matvec_mode overrides
    family: str = "gru"
    quant: str = ""                  # "" (f32) | "int8": makes the q8
                                     # backends (cuda_fused_q8,
                                     # cuda_chain_q8) candidates,
                                     # chosen without a pin only when the
                                     # quant accuracy gate is open
    seq_len: int = 20                # a training example's time steps

    @property
    def resolved_num_layers(self) -> int:
        return len(self.layer_dims) if self.layer_dims else self.num_layers

    @property
    def resolved_layer_dims(self) -> Tuple[int, ...]:
        """Hidden size of every layer, layer 0 first."""
        if self.layer_dims:
            return tuple(self.layer_dims)
        return (self.hidden_dim,) * self.num_layers

    def layer_input_dim(self, layer: int) -> int:
        """Input width of ``layer``: raw features for layer 0, previous
        hidden size above it."""
        if layer == 0:
            return self.input_dim
        return self.resolved_layer_dims[layer - 1]

    def layer_matvec_mode(self, layer: int) -> str:
        if self.layer_matvec_modes:
            return self.layer_matvec_modes[layer]
        return self.matvec_mode


@dataclass(frozen=True)
class ModelConfig:
    """The fields of ``repro.configs.base.ModelConfig`` that the port's
    families read: the recurrent stack (``gru``) for the cell families,
    the transformer's fields for ``family="dense"`` and ``"moe"`` (the
    latter with ``moe``), with ``xlstm`` for ``"ssm"`` and ``ssm``,
    ``sliding_window`` and ``global_attn_layers`` for ``"hybrid"``,
    ``encoder`` for ``"audio"`` and ``vision`` for ``"vlm"``.

    ``attn_impl`` takes the port's names: ``"naive"`` (dense score
    matrix, the oracle; JAX ``"naive"``), ``"chunked"`` (the plain chunked
    online softmax; JAX ``"xla_flash"``) and ``"cuda"`` (the two CUDA
    kernels, flash attention for prefill and flash decode; JAX
    ``"pallas"``). The default differs from JAX's (``"xla_flash"``) on
    purpose: the port's entry points run its kernels on the card (and
    their plain versions on CPU tensors). ``attn_chunk`` is the kv chunk
    of ``"chunked"``; the kernels choose their own tiles.
    ``scan_layers`` and ``remat`` are XLA compile knobs: the port accepts
    them and they change nothing (it runs its layers eagerly).
    """
    name: str
    family: str                      # gru|slstm|dense|moe|ssm|hybrid|audio|vlm
    gru: Optional[GRUConfig] = None
    param_dtype: str = "float32"
    # --- the transformer LM (zero for the cell families) ---
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10_000.0
    rope: bool = True
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu
    parallel_block: bool = False     # cohere-style attn || mlp
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()  # layers that ignore
                                     # sliding_window (hymba: recorded; its
                                     # groups come from the layer count)
    dtype: str = "bfloat16"          # activation/compute dtype
    scan_layers: bool = True         # accepted; changes nothing here
    remat: bool = True               # accepted; changes nothing here
    attn_impl: str = "cuda"          # "cuda" | "chunked" | "naive"
    attn_chunk: int = 1024           # kv chunk of "chunked"
    moe: Optional[MoEConfig] = None  # the experts of family "moe"
    ssm: Optional[SSMConfig] = None  # hymba's SSM heads (family "hybrid")
    xlstm: Optional[XLSTMConfig] = None  # the xLSTM blocks (family "ssm")
    encoder: Optional[EncoderConfig] = None  # whisper's encoder ("audio")
    vision: Optional[VisionStubConfig] = None  # llava's patches ("vlm")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid", "gru", "slstm")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: recurrent/hybrid archs only."""
        return self.family in ("ssm", "hybrid", "gru", "slstm")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), JAX's
        arithmetic: the experts count ``num_experts``, not the padded
        count the spec tree holds (``models.moe.padded_experts``)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d
        mlp = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        if self.moe is not None:
            m = self.moe
            emlp = m.num_experts * 3 * d * m.d_expert + d * m.num_experts
            if m.shared_d_ff:
                emlp += 3 * d * m.shared_d_ff
            per_layer = attn + emlp + 2 * d
        total = self.num_layers * per_layer + self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.encoder is not None:
            total += self.encoder.num_layers * (attn * 2 + mlp + 3 * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        full_moe = m.num_experts * 3 * d * m.d_expert
        active_moe = m.top_k * 3 * d * m.d_expert
        return self.param_count() - self.num_layers * (full_moe - active_moe)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    grad_compression: str = "none"   # none | bf16 | int8_ef (error feedback)
    opt_dtype: str = "float32"       # Adam moment dtype


_REGISTRY = {
    "gru-jet": "gru_jet",
    "gru-jet-deep": "gru_jet_deep",
    "slstm-jet": "slstm_jet",
    "xlstm-125m": "xlstm_125m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-0.6b": "qwen3_0_6b",
    "command-r-35b": "command_r_35b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "whisper-large-v3": "whisper_large_v3",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ASSIGNED_ARCHS = [a for a in _REGISTRY
                  if not a.startswith(("gru-jet", "slstm-jet"))]
ALL_ARCHS = list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.SMOKE
