"""Typed configuration for litemkd_torch.

The port's own copy of the JAX package's config schema: the same dataclasses,
fields, defaults and presets, so a config written by one package reads in the
other. ``tests/test_torch_port_eval.py`` holds every preset equal to the
JAX package's.

Episode geometry is static per run (way/shot/queries/seq_len).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

@dataclass(frozen=True)
class EpisodeConfig:
    """N-way K-shot episode geometry (reference: options.py:12-25)."""

    way: int = 5
    shot: int = 5
    query_per_class: int = 5       # train queries per class
    query_per_class_test: int = 1  # test queries per class
    seq_len: int = 8               # frames per video
    img_size: int = 224

    @property
    def n_support(self) -> int:
        return self.way * self.shot

    def n_queries(self, train: bool = True) -> int:
        return self.way * (self.query_per_class if train else self.query_per_class_test)


@dataclass(frozen=True)
class ModelConfig:
    """Model-zoo selection + transformer dims (reference: options.py:22-26, 35, 41-43)."""

    backbone: str = "resnet18_2fc"      # see models.backbones registry
    classifier: str = "TRX_2fcsup"      # see models.classifiers registry
    teacher: str = "TRX_2fcsup_fixed"   # teacher head (operates on fused features)
    trans_linear_in_dim: int = 2048     # feature dim fed to episodic heads
    trans_linear_out_dim: int = 1152    # TCT key/value dim
    temp_set: Tuple[int, ...] = (2,)    # temporal tuple cardinalities
    trans_dropout: float = 0.1
    # MFM teacher knobs (reference: teacher/code/multi_fusion.py:136-372)
    trans_num: int = 2                  # encoder depth in fusion blocks
    shirt_num: int = 1                  # circular time-shift for modality 2/3
    modalities: Tuple[str, ...] = ("rgb", "depth", "flow")
    # compute policy
    compute_dtype: str = "bfloat16"     # conv dtype of the trunk
    param_dtype: str = "float32"
    remat: bool = False                 # rematerialize trunk blocks (saves HBM)
    use_pallas: bool = False            # JAX: fused Pallas TCT kernel. The port
                                        # launches its CUDA kernel on every
                                        # CUDA tensor and ignores this flag
    pallas_bn: bool = False             # Pallas-reduced BN training moments
                                        # (resnet trunks)
    freeze_bn: bool = False             # BN uses running stats during training
                                        # (finetune mode, ~15% faster steps)


@dataclass(frozen=True)
class DistillConfig:
    """Loss weights, mirroring the reference ``cfg`` dict (options.py:51-60)."""

    name: str = "fc_2_sup_dist"
    soft_loss_weight_support: float = 1.0
    soft_loss_weight_query: float = 1.0
    hard_loss_weight: float = 1.0
    soft_loss_weight: float = 2.0
    feature_loss_weight: float = 1.0
    temperature: float = 4.0
    fcwsl_aerfa: float = 0.5
    fcwsl_beta: float = 1.0
    sup_weight: float = 0.5  # weight of the support-relation (DIST) term in fc_2_sup_dist


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference: options.py:18, 27-30, 64-76)."""

    tasks_per_batch: int = 16           # episodes per optimizer step (ref: grad accum)
    micro_batch: int = 0                # >0: episodes per fused fwd/bwd chunk
                                        # (lax.scan grad accumulation, bounds HBM)
    training_iterations: int = 100_010  # counted in *episodes*, like the reference
    learning_rate: float = 1e-4
    optimizer: str = "sgd"              # "sgd" | "adam"
    sch: Tuple[int, ...] = (20_000, 40_000)  # episode milestones for 0.1x LR decay
    sch_gamma: float = 0.1
    save_freq: int = 10_000
    print_freq: int = 10
    test_iters: Tuple[int, ...] = (10_000, 15_000, 20_000, 30_000, 35_000, 40_000,
                                   50_000, 60_000, 70_000, 80_000, 90_000, 100_000)
    num_test_tasks: int = 5_000
    seed: int = 3483                    # the reference's fixed seed (TRX.py:18-21)
    checkpoint_dir: Optional[str] = None
    resume_from_checkpoint: bool = False
    watch: bool = False                 # per-module grad/param norms in the
                                        # metrics stream (wandb.watch analog,
                                        # trainwandb.py:52)


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths (reference: options.py:126-159)."""

    dataset: str = "ucf"                 # ssv2 | kinetics | hmdb | ucf | synthetic
    split: int = 3
    traintestlist: Optional[str] = None  # dir containing trainlist{split:02d}.txt etc.
    rgb_path: Optional[str] = None       # frame tree: <class>/<video>/<frame>.jpg
    teacher_path: Optional[str] = None   # fused feature tree: <class>/<video>/feature.npy
    num_workers: int = 4
    prefetch: int = 2
    fixed_episode_file: Optional[str] = None  # JSON replay of fixed test episodes
    synthetic_noise: float = 0.3         # synthetic-dataset difficulty: per-
                                         # sample noise scale around the class
                                         # prototypes (higher = harder)
    # multi-camera (dance-style) datasets with an ``all_view_rgb_l8/<view>/
    # <class>/<video>`` sibling tree (reference run.py --cross_view/--view/
    # --fixed_view, video_reader.py:255-343): cross_view draws each SUPPORT
    # clip from a random camera and every QUERY clip from views[query_view];
    # fixed_view pins every clip to one named view (the commented-out intent
    # of get_fixed_view_modality_seq — as released that path degenerates to
    # the primary tree)
    cross_view: bool = False
    query_view: int = 3
    fixed_view: Optional[str] = None
    view_root: Optional[str] = None      # defaults to <rgb_path>/../all_view_rgb_l8


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the JAX package (data × model axes); kept so
    configs round-trip between the packages. The port runs on one device."""

    data: int = -1    # -1: all remaining devices on the data axis
    model: int = 1    # tensor-parallel width for the wide projections


@dataclass(frozen=True)
class Config:
    episode: EpisodeConfig = field(default_factory=EpisodeConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    mode: str = "litemkd"  # experiment description tag

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        def build(cls, sub):
            kw = dict(sub)
            for k, v in kw.items():
                if isinstance(v, list):
                    kw[k] = tuple(v)
            return cls(**kw)

        return Config(
            episode=build(EpisodeConfig, d.get("episode", {})),
            model=build(ModelConfig, d.get("model", {})),
            distill=build(DistillConfig, d.get("distill", {})),
            train=build(TrainConfig, d.get("train", {})),
            data=build(DataConfig, d.get("data", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
            mode=d.get("mode", "litemkd"),
        )


# ---------------------------------------------------------------------------
# Presets mirroring the reference's shell entry points.
# ---------------------------------------------------------------------------

def preset(name: str, **overrides) -> Config:
    """Named presets: the canonical configurations from the reference's scripts."""
    # every 224px image-trunk preset runs micro_batch=4: the fully-fused
    # 16-episode fwd/bwd (micro_batch=0) holds ~6 GB of stem activations per
    # 4 episodes and OOMs a 16 GB v5e at compile; lax.scan over 4-episode
    # slices has identical loss/BN-chain semantics and measured-equal
    # throughput (NOTES perf log #3). Feature-space configs (mfm_teacher,
    # tiny) keep the fused default.
    mb4 = TrainConfig(micro_batch=4)
    presets = {
        # train_wandb.sh:20-32 — the paper's student run
        "student_fc2sup_dist": Config(train=mb4),
        # plain student, no distillation (ce loss on single TRX head)
        "student_plain": Config(
            model=ModelConfig(backbone="resnet18_student", classifier="TRX"),
            distill=DistillConfig(name="ce"),
            train=mb4,
        ),
        # teacher/code/scripts/hmdb/multi_fusion_r+d+f.sh — the MFM fusion teacher
        "mfm_teacher": Config(
            model=ModelConfig(backbone="feature", classifier="MFM",
                              trans_num=2, shirt_num=1),
            distill=DistillConfig(name="ce"),
            # canonical script (scripts/hmdb/multi_fusion_r+d+f.sh): 50015
            # iterations, save 5000; multi_fusion.py's --sch DEFAULTS to
            # [1000000] and no released script overrides it — the fusion
            # teacher never decays its lr (unlike the student's 20k/40k)
            train=TrainConfig(learning_rate=5e-5, training_iterations=50_015,
                              save_freq=5000, sch=(1_000_000,)),
        ),
        # mobilenet student variant (Readme.md:160-163)
        "student_mobilenet": Config(
            model=ModelConfig(backbone="mobilenetv3_large_2fc", classifier="TRX_2fcsup"),
            train=mb4,
        ),
        # per-modality TRX expert stage (teacher/code/run.py via
        # scripts/*/run/*_trx_run.sh: resnet50, qpc 4, lr 1e-4 SGD, dk 1152)
        "expert_trx": Config(
            episode=EpisodeConfig(query_per_class=4),
            model=ModelConfig(backbone="resnet50_student", classifier="TRX"),
            distill=DistillConfig(name="TRXLoss"),
            train=TrainConfig(learning_rate=1e-4, training_iterations=50010,
                              micro_batch=4, sch=(1_000_000,)),
        ),
        # per-modality CNN_STRM expert (scripts/*/trx/{rgb,flow,depth}_strm.sh:
        # resnet50 STRM trunk, run.py:330-337's task_loss + 0.1·pat joint CE,
        # lr 3e-4, qpc 4, 70010 iters)
        "expert_strm": Config(
            episode=EpisodeConfig(query_per_class=4),
            model=ModelConfig(backbone="cnn_strm", classifier="strmclassifiers"),
            distill=DistillConfig(name="strm_expert"),
            train=TrainConfig(learning_rate=3e-4, training_iterations=70010,
                              micro_batch=4, sch=(1_000_000,)),
        ),
        # per-modality Baseline expert (scripts/*/run/5-shot/*_Baseline_50.sh:
        # resnet50 GAP + euclidean class-mean prototypes, CELoss, lr 3e-4)
        "expert_baseline": Config(
            episode=EpisodeConfig(query_per_class=4),
            model=ModelConfig(backbone="resnet50_gap", classifier="e_dist"),
            distill=DistillConfig(name="CELoss"),
            train=TrainConfig(learning_rate=3e-4, training_iterations=70020,
                              micro_batch=4, sch=(1_000_000,)),
        ),
        # skeleton-modality TRX expert (scripts/*/run/5-shot/
        # skeleton_trx_run.sh: skeleton encoder + TRX head, lr 1e-4)
        "expert_skeleton_trx": Config(
            episode=EpisodeConfig(query_per_class=4),
            model=ModelConfig(backbone="s3d", classifier="TRX"),
            distill=DistillConfig(name="TRXLoss"),
            train=TrainConfig(learning_rate=1e-4, training_iterations=50010,
                              sch=(1_000_000,)),
        ),
        # tiny geometry for tests / dryruns
        "tiny": Config(
            episode=EpisodeConfig(way=3, shot=2, query_per_class=2,
                                  query_per_class_test=1, seq_len=4, img_size=32),
            model=ModelConfig(trans_linear_in_dim=64, trans_linear_out_dim=32,
                              trans_num=1),
            train=TrainConfig(tasks_per_batch=2, training_iterations=4,
                              num_test_tasks=2, sch=(2,)),
            data=DataConfig(dataset="synthetic"),
        ),
    }
    cfg = presets[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
