"""mcan_vqa_tpu_torch — the PyTorch/CUDA port of mcan_vqa_tpu for NVIDIA
Hopper (H100).

The JAX package ``mcan_vqa_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find. It imports ``torch`` and
never JAX, and nothing of the JAX package: the host-side helpers it needs
(vocabulary, answer dictionary, request padding) are its own copies.

Subpackages
-----------
configs   MCAN-small dimensions, training, evaluation and path settings as
          a dataclass
data      vocabulary, answers, request padding, region features, the VQA-v2
          and synthetic datasets, the batch loader
models    nn.Modules with the reference Net2 state_dict keys (the "plain"
          engine)
ops       hand-written CUDA kernels (csrc/) and their plain PyTorch
          versions: the serving blocks and the SGA train block
train     the training forward, train and eval steps, AdamW schedule,
          Trainer (training and evaluation) and checkpoints
evals     the official VQA-v2 accuracy, ROC-AUC, the reference's VQA /
          VQAEval API
cli       ``run_vqa --run train|val|test|parity``, ``pack_features``, the
          accuracy canary, the train-step profiler and the benches
api       Predictor: questions + region features in, answers out
"""

__version__ = "0.1.0"
