"""mcan_vqa_tpu_torch — the PyTorch/CUDA port of mcan_vqa_tpu for NVIDIA
Hopper (H100).

The JAX package ``mcan_vqa_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find. It imports ``torch`` and
never JAX, and nothing of the JAX package: the host-side helpers it needs
(vocabulary, answer dictionary, request padding) are its own copies.

Subpackages
-----------
configs   MCAN-small dimensions and training settings as a dataclass
data      vocabulary, answers, request padding, the synthetic training set,
          the batch loader
models    nn.Modules with the reference Net2 state_dict keys (the "plain"
          engine)
ops       hand-written CUDA kernels (csrc/) and their plain PyTorch
          versions: the serving blocks and the SGA train block
train     the training forward, train step, AdamW schedule, Trainer and
          checkpoints
cli       ``run_vqa --run train`` and the train-step profiler
api       Predictor: questions + region features in, answers out
"""

__version__ = "0.1.0"
