"""Typed configuration tree — a copy of ``graph_transformer_tpu/config.py``.

The port keeps its own copy so that it imports nothing of the JAX package;
both packages read configurations that look alike.  The flags that choose
among TPU kernels choose the port's paths as they choose JAX's: the fused
sampled path needs ``use_fused_sampler``, ``use_pallas`` and
``use_pallas_whole_encoder`` (``train/sup_trainer.fused_gate_ok``), and on
it ``use_folded`` and ``use_stored_bwd`` pick K1-K3, K5/K6 or K13
(``ops/stored_encoder.training_encoder``).  Off the fused path the port
runs its own kernels whatever ``use_pallas`` and
``use_pallas_whole_encoder`` say, where JAX runs XLA without them.

The reference threads a mutable, untyped ``Namespace`` dict-bag through every
loader/trainer and mutates it in place (reference: ``U2GNN_pytorch/util.py:36-41``,
``train_utils.py:126-133``).  Here the configuration is one frozen dataclass
tree; anything derived from data (feature dim, vocab size, padded shapes) lives
on the dataset/batch objects instead of being written back into the config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + batching options.

    Mirrors the CLI surface of the reference trainers
    (``train_pytorch_U2GNN_Sup.py:24-39``).
    """

    dataset: str = "MUTAG"
    data_dir: Optional[str] = None  # default: $GT_TPU_DATA
    # None = auto (forced on for COLLAB/IMDB* as in the reference)
    degree_as_tag: Optional[bool] = None
    # Continuous per-node attributes from <dataset>_node_attributes.txt
    # (replaces one-hot tags when the sidecar exists; the reference's dead
    # attribute branch done right — util.py:97-98).  Lifts ENZYMES-class
    # datasets where attributes carry the signal.
    use_node_attributes: bool = False
    fold_idx: int = 0
    batch_size: int = 4
    num_neighbors: int = 8  # fanout K; neighborhood length is K+1 (self at slot 0)
    # Padding: node-axis bucket multiple. Static shapes keep XLA from recompiling.
    pad_multiple: int = 128
    # REDDIT feature rule: constant 4-dim features scaled by 0.01
    # (reference: train_pytorch_U2GNN_Sup.py:55-56,93-95).
    seed: int = 123


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """U2GNN-family model hyperparameters.

    ``num_timesteps`` is T, the number of self-attention layers inside each
    U2GNN layer; ``num_hidden_layers`` is k, the number of stacked U2GNN layers
    (reference: ``train_pytorch_U2GNN_Sup.py:34-36``).
    """

    model: str = "u2gnn_sup"  # u2gnn_sup | u2gnn_unsup | gcn | gat | ml_u2gnn
    ff_hidden_size: int = 1024
    num_timesteps: int = 1
    num_hidden_layers: int = 1
    num_heads: int = 1  # reference uses nhead=1 throughout
    dropout: float = 0.5
    sampled_num: int = 512  # candidates for sampled softmax (unsup)
    # Attention axis. "neighborhood" is the intended semantics (TF impl,
    # model_U2GNN_Sup_multi.py:14-15). "node" reproduces the PyTorch axis quirk
    # (pytorch_U2GNN_Sup.py:32-36 feeds [N, K+1, d] to a (S, B, E) encoder, so
    # attention runs across the node axis) for activation-parity checks.
    attention_axis: str = "neighborhood"
    # Weight sharing across the T timesteps (Universal-Transformer recurrence,
    # the TF implementation's semantics via tf.foldl:
    # universal_transformer_modified_utils.py:251-252). False matches the
    # PyTorch implementation (T independent TransformerEncoder layers).
    share_timestep_weights: bool = False
    # Universal-Transformer transition function between timesteps
    # (the vendored t2t recurrence zoo,
    # universal_transformer_modified_utils.py:552-1654):
    # basic | skip | highway | gru | act.  Non-basic implies weight tying.
    recurrence: str = "basic"
    # ACT ponder-cost regularization weight: loss += w * ponder, the t2t
    # act_loss (universal_transformer_modified.py:343; t2t hparam default
    # 0.01).  Only active when recurrence == "act".
    act_loss_weight: float = 0.01
    # Loss head for unsupervised models: default (sampled softmax) | gae | contrastive
    loss_type: str = "default"
    # Negative-candidate source for loss_type='default':
    # "default" = log-uniform vocabulary sampling (SampledSoftmax),
    # "neighbor" = graph neighbors of the label node (SampledNeighbor,
    # ``pytorch_U2GNN_UnSup.py:43-46`` dispatch).
    sampler_type: str = "default"
    # Sampled-softmax flavor: "reference" reproduces sampled_softmax.py:36-56
    # (no expected-count correction); "tf" matches tf.nn.sampled_softmax_loss
    # (subtract log expected count + accidental-hit masking), the clean
    # semantics of model_U2GNN_Unsup_multi.py:56-58.
    sampled_softmax_mode: str = "tf"
    # Id-symmetric unsup protocol (round-4 file-order-leak control,
    # ROADMAP 8c): train node v's output-embedding row at a per-run random
    # permuted index π(v), cutting the id->label channel inside the loss
    # with zero data-pipeline cost (equivalent in effect to permute_graphs;
    # verified on PTC/IMDBBINARY, runs/id_symmetric_check.json).
    id_symmetric: bool = False
    # Multilayer (multiplex) wrapper options (python_multi_layer_siamese_u2gnn.py)
    ml_model_type: str = "siamese"  # siamese | multi
    projection_dim: int = -1
    label_smoothing: float = 0.1
    # Compute dtype for the encoder matmuls (params stay float32).
    compute_dtype: str = "float32"  # or "bfloat16"
    use_pallas: bool = False  # fused Pallas neighborhood-attention kernel
    # Whole-encoder mega-kernel (ops/pallas_u2gnn.py: all T layers + slot-0
    # in one fwd/bwd pallas_call).  Off by default: its forward beats the
    # per-layer kernels (2.61 vs 3.06 ms at bench shapes) but its backward
    # loses (VMEM-pressure spills at tile 504; slower at smaller tiles), so
    # the per-layer kernels remain the fast path until the fused backward
    # wins (see runs/mega_kernel_probe notes in BASELINE.md).
    use_pallas_whole_encoder: bool = False
    # Fully-fused sample+gather+encode (ops/pallas_sampled_encoder.py):
    # skips the separate sampler kernel AND the feature gather when the
    # dataset's features are one-hot tags (TU/REDDIT regime).  Requires
    # use_pallas_whole_encoder, single hidden layer, basic recurrence.
    use_fused_sampler: bool = False
    # Stored-residual backward for the fused sampled encoder
    # (ops/pallas_stored_bwd.py): the forward writes each layer's residuals
    # (FFN hidden bf16, qkv, small strip) and the backward reads them
    # instead of re-running the layer forward.  Measured A/B at bench
    # shapes: encoder grad loop 8.33 -> 7.54 ms/step, grads CLOSER to the
    # f32 reference than the recompute path (scripts/bench_stored_bwd.py,
    # runs/stored_bwd_ab.json).
    use_stored_bwd: bool = False
    # Folded-lane [G, S·D] encoder (ops/pallas_folded.py): each
    # neighborhood becomes ONE row of S·D lanes and every per-slot op a
    # constant-matrix MXU contraction — no dense [R, R] attention, no
    # 4/128-lane glue.  Measured at bench shapes: encoder grad loop
    # 7.55 -> 4.69 ms/step over the stored path (runs/folded_ab.json).
    # Takes precedence over use_stored_bwd on the fused sampled path.
    use_folded: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh / sharding options (new capability; the reference is
    single-process single-device, SURVEY.md §2.3)."""

    data_axis: int = 1  # number of data-parallel shards (graphs/nodes)
    model_axis: int = 1  # reserved for tensor parallelism of ff layers
    mesh_axes: Tuple[str, ...] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule, matching the reference trainer semantics:
    Adam + global-norm clip 0.5 + StepLR(gamma=0.1) stepped when the epoch
    loss exceeds the mean of the previous five
    (``train_pytorch_U2GNN_Sup.py:145-160,209-210``)."""

    learning_rate: float = 5e-4
    num_epochs: int = 50
    grad_clip_norm: float = 0.5
    lr_decay_gamma: float = 0.1
    plateau_window: int = 5
    eval_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # epochs; 0 = disabled
    seed: int = 123
    on_device_sampling: bool = True  # neighbor fanout sampling inside the jitted step
    # Run each epoch as ONE device dispatch (host pre-builds + stacks the
    # epoch's batches, lax.scan trains).  Big win when per-dispatch latency
    # dominates (small batches / remote device); costs one extra copy of the
    # epoch's batch arrays in device memory.
    scan_epochs: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
