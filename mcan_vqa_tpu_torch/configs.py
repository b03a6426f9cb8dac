"""Model and training settings for the port.

The JAX ``Config`` reads YAML, which the port does not depend on, so the
settings the port uses live here as a dataclass. Defaults are MCAN-small:
``mcan_vqa_tpu/configs/small.yml`` over the dataclass defaults of
``mcan_vqa_tpu/configs/config.py``, with ``ff_size = 4 * hidden`` as
``config.py:194`` derives it (``with_overrides`` keeps that rule).
``Config.for_model("large")`` is MCAN-large, ``configs/large.yml`` over the
same defaults (the YAMLs' ``ckpt_version`` / ``ckpt_epoch`` are not taken
over: they name a published checkpoint, and the port's defaults evaluate
the run's own). Field names follow the JAX ``Config`` so a reader can map
one onto the other, and so do the dataset paths and the VQA-v2 file
tables (``img_feat_path``, ``question_path``, ``answer_path``;
cfgs/path_cfgs.py:22-77) and the MIMIC-CXR ones (``mimic_qa_path``,
``mimic_ans_dict_path``, ``check_mimic_paths``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from mcan_vqa_tpu_torch.parallel.mesh import validate_shape

# the settings each model's YAML sets over the defaults (small.yml sets
# only values the defaults already have)
TRAIN_ENGINES = EVAL_ENGINES = ("auto", "fused", "plain")
DROPOUT_BITS = (8, 16, 32)
STACKED_PARAMS = ("auto", "on", "off", True, False)
MU_DTYPES = ("", "bfloat16")
MIMIC_FEAT_SOURCES = ("regions", "anatomy", "both")
MODELS: Dict[str, Dict[str, Any]] = {
    "small": {},
    "large": dict(hidden_size=1024, ff_size=4096, flat_out_size=2048,
                  lr_base=5e-5, grad_accu_steps=2),
}


@dataclass(frozen=True)
class Config:
    # ---- the network (config.py:39-50, 116-141; small.yml)
    word_embed_size: int = 300
    hidden_size: int = 512
    layer: int = 6
    multi_head: int = 8
    ff_size: int = 2048
    img_feat_size: int = 2048
    img_feat_pad_size: int = 60
    max_token: int = 14
    flat_mlp_size: int = 512
    flat_glimpses: int = 1
    flat_out_size: int = 512
    dropout_rate: float = 0.1
    # random bits drawn per dropout keep decision of an external mask or a
    # plain site: 32 (exact rate), 16 or 8 (config.py:118)
    dropout_bits: int = 32

    # ---- training (config.py:24-31, 50-86, 158-162)
    seed: int = 444
    version: str = ""              # "" means str(seed)
    batch_size: int = 64
    grad_accu_steps: int = 1
    lr_base: float = 1e-4
    lr_decay_rate: float = 0.2
    lr_decay_list: Tuple[int, ...] = (8, 12)
    max_epoch: int = 13
    grad_norm_clip: float = -1.0
    # per-parameter gradient norms summed on the host and written to the
    # JSONL log every K steps and at each epoch's end; 0 is off
    # (config.py:67, core/exec.py:199-202)
    grad_norm_log_every: int = 0
    # AdamW (config.py:73-78): the reference declares (0.9, 0.98) / 1e-9
    # but never passes them, so torch's defaults are the live ones;
    # opt_mu_dtype "bfloat16" stores the first moment in bf16 (optax
    # mu_dtype), "" keeps it f32
    opt_betas: Tuple[float, float] = (0.9, 0.999)
    opt_eps: float = 1e-8
    weight_decay: float = 1e-4
    opt_mu_dtype: str = ""
    reg_factor: float = 0.0
    # the reference's MUTAN fusion rank (run_mimic.py --mutan_gamma): taken
    # and kept, read by no model, as in the JAX package (config.py:83)
    mutan_gamma: int = 2
    verbose: bool = True
    ckpts_dir: str = "./ckpts/"
    log_path: str = "./results/log/"
    # "auto": the fused train engine on a CUDA device at hidden % 128 == 0
    # and hidden <= 1024, else the plain one; "fused" forces the fused
    # engine (on the CPU its kernels' plain versions, test-only); "plain"
    # always the plain engine (config.py:136, trainer.py:540-567)
    train_engine: str = "auto"
    # the stacked parameter layout of the fused VQA train engine
    # (ops/stacked_params.py, config.py:137-148): "on" trains from one
    # [L, ...] leaf per block weight role, already in the train kernels'
    # layout; "off" from the standard leaves; "auto" resolves off, as in
    # JAX (trainer.py:265-271). Bools are taken as "on" / "off". Ignored,
    # with a log line, where the fused VQA engine does not run
    stacked_params: Any = "auto"
    # the checkpoint lifecycle (config.py:28, :99-100, :130, :149):
    # resume from the checkpoint the ckpt_* fields name; keep only the
    # newest keep_last_ckpts epochs (0 keeps all); write the epoch pickles
    # on a background thread; calibrate static int8 activation scales on
    # the last train batch and store them beside the last pickle; a
    # torch.profiler trace of the epochs into profile_dir ("" is off)
    resume: bool = False
    keep_last_ckpts: int = 0
    ckpt_async: bool = False
    ckpt_calibrate: bool = True
    profile_dir: str = ""
    # the device mesh of a run under torch.distributed (config.py:94):
    # {"data": dp, "model": tp}, dp x tp ranks, tp on the minor axis; "data"
    # -1 takes every rank not on the model axis (parallel/mesh.py)
    mesh_shape: Dict[str, int] = field(
        default_factory=lambda: {"data": 1, "model": 1})

    # ---- evaluation and data (config.py:35-39, :105, :119-121)
    eval_every_epoch: bool = True
    # "auto": the shipped int8 serving engine on a CUDA device, the plain
    # model elsewhere; "fused" forces the serving engine (on the CPU its
    # kernels' plain versions, test-only); "plain" always the plain model
    eval_engine: str = "auto"
    # the classifier's in-epoch evaluation every eval_interval steps; <= 0
    # is off (config.py:82, core/exec.py:940-951)
    eval_interval: int = 1000
    eval_strict: bool = False      # refuse predictions that miss a question
    test_save_pred: bool = False   # dump the probabilities of each evaluation
    train_split: str = "train+val+vg"
    use_glove: bool = True
    preload: bool = False          # npz features read into memory up front
    # the checkpoint evaluated by run_vqa --run val / test / parity: a
    # pickle by path, else <ckpts_dir>/ckpt_<ckpt_version>/epoch<ckpt_epoch>
    ckpt_version: str = ""         # "" means run_version
    ckpt_epoch: int = 0
    ckpt_path: str = ""

    # ---- paths (config.py:151-163)
    dataset_path: str = "./datasets/vqa/"
    feature_path: str = "./datasets/coco_extract/"
    feature_cache_path: str = "./datasets/feature_cache/"
    vocab_cache_path: str = "./results/cache/vocab.npz"
    result_path: str = "./results/result_test/"
    pred_path: str = "./results/pred/"
    # MIMIC-CXR (config.py:88-90, :156-157): the pickles' common prefix, the
    # region feature bank ([N, 60, 1024] "image_features": HDF5, or the
    # array itself as .npy) and the pooled anatomy bank ([N, 26, 1024]);
    # mimic_feat_source picks the model's image rows: the 60 regions, the
    # 26 anatomy rows, or both (regions then anatomy: img_feat_pad_size >=
    # 86)
    cxr_data_path: str = "./datasets/mimic/mimic_"
    cxr_img_feat_path: str = "./datasets/mimic/cmb_bbox_features_full.hdf5"
    ana_pool_finding_path: str = \
        "./datasets/mimic/bbox_disease_features_by_coords.hdf5"
    mimic_feat_source: str = "regions"

    def __post_init__(self):
        if self.hidden_size % self.multi_head:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not a multiple of "
                f"multi_head {self.multi_head}")
        if self.batch_size % self.grad_accu_steps:
            raise ValueError(
                f"batch_size {self.batch_size} is not a multiple of "
                f"grad_accu_steps {self.grad_accu_steps}")
        if self.train_engine not in TRAIN_ENGINES:
            raise ValueError(f"train_engine must be one of {TRAIN_ENGINES}, "
                             f"got {self.train_engine!r}")
        if self.stacked_params not in STACKED_PARAMS:
            raise ValueError(f"stacked_params must be 'auto', 'on' or "
                             f"'off', got {self.stacked_params!r}")
        if self.eval_engine not in EVAL_ENGINES:
            raise ValueError(f"eval_engine must be one of {EVAL_ENGINES}, "
                             f"got {self.eval_engine!r}")
        if self.dropout_bits not in DROPOUT_BITS:
            raise ValueError(f"dropout_bits must be one of {DROPOUT_BITS}, "
                             f"got {self.dropout_bits!r}")
        if self.opt_mu_dtype not in MU_DTYPES:
            raise ValueError(f"opt_mu_dtype must be one of {MU_DTYPES}, "
                             f"got {self.opt_mu_dtype!r}")
        if len(self.opt_betas) != 2 or not all(
                0.0 <= b < 1.0 for b in self.opt_betas):
            raise ValueError(f"opt_betas must be two values in [0, 1), got "
                             f"{self.opt_betas!r}")
        if self.opt_eps < 0.0 or self.weight_decay < 0.0:
            raise ValueError(
                f"opt_eps and weight_decay must be >= 0, got "
                f"{self.opt_eps!r} and {self.weight_decay!r}")
        if self.mimic_feat_source not in MIMIC_FEAT_SOURCES:
            raise ValueError(f"mimic_feat_source must be one of "
                             f"{MIMIC_FEAT_SOURCES}, got "
                             f"{self.mimic_feat_source!r}")
        validate_shape(self.mesh_shape)
        for name in ("keep_last_ckpts", "grad_norm_log_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)!r}")

    @classmethod
    def for_model(cls, model: str = "small", **overrides: Any) -> "Config":
        """MCAN-small or MCAN-large (``MODELS``), then ``overrides`` as
        ``with_overrides`` applies them."""
        if model not in MODELS:
            raise ValueError(f"model must be one of {tuple(MODELS)}, got "
                             f"{model!r}")
        return cls(**MODELS[model]).with_overrides(**overrides)

    @property
    def run_version(self) -> str:
        return self.version or str(self.seed)

    @property
    def eval_batch_size(self) -> int:
        """The micro-batch (config.py:196-197)."""
        return self.batch_size // self.grad_accu_steps

    @property
    def img_feat_path(self) -> Dict[str, str]:
        return {
            "train": os.path.join(self.feature_path, "train2014/"),
            "val": os.path.join(self.feature_path, "val2014/"),
            "test": os.path.join(self.feature_path, "test2015/"),
        }

    @property
    def question_path(self) -> Dict[str, str]:
        q = "v2_OpenEnded_mscoco_{}_questions.json"
        return {
            "train": os.path.join(self.dataset_path, q.format("train2014")),
            "val": os.path.join(self.dataset_path, q.format("val2014")),
            "test": os.path.join(self.dataset_path, q.format("test2015")),
            "vg": os.path.join(self.dataset_path, "VG_questions.json"),
        }

    @property
    def answer_path(self) -> Dict[str, str]:
        a = "v2_mscoco_{}_annotations.json"
        return {
            "train": os.path.join(self.dataset_path, a.format("train2014")),
            "val": os.path.join(self.dataset_path, a.format("val2014")),
            "vg": os.path.join(self.dataset_path, "VG_annotations.json"),
        }

    def check_vqa_paths(self) -> List[str]:
        """The VQA-v2 paths that are missing (reference
        cfgs/path_cfgs.py:79-97)."""
        return [p for table in (self.img_feat_path, self.question_path,
                                self.answer_path)
                for p in table.values() if not os.path.exists(p)]

    @property
    def mimic_qa_path(self) -> Dict[str, str]:
        return {split: f"{self.cxr_data_path}dataset_{split}_full.pkl"
                for split in ("train", "val", "test")}

    @property
    def mimic_ans_dict_path(self) -> Dict[str, str]:
        return {"ans2idx": self.cxr_data_path + "ans2label_full.pkl",
                "idx2ans": self.cxr_data_path + "label2ans_full.pkl"}

    def check_mimic_paths(self) -> List[str]:
        """The MIMIC-CXR paths that are missing (config.py:290-306): the
        region bank, the three QA pickles, and the anatomy bank wherever
        the feature source reads it."""
        missing = [p for p in (self.cxr_img_feat_path,
                               *self.mimic_qa_path.values())
                   if not os.path.exists(p)]
        if self.mimic_feat_source != "regions":
            ana = self.ana_pool_finding_path
            if not (ana and os.path.exists(ana)):
                missing.append(ana or "ana_pool_finding_path (unset)")
        return missing

    def with_overrides(self, **kw: Any) -> "Config":
        """A copy with ``kw`` set; a new hidden_size brings ff_size = 4 x
        hidden_size unless ff_size is given too."""
        if "hidden_size" in kw and "ff_size" not in kw:
            kw["ff_size"] = 4 * kw["hidden_size"]
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
