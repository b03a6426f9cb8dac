"""Evaluation of the port: the official VQA-v2 accuracy (``vqa_eval``),
ROC-AUC for multi-label targets (``roc_auc``) and the reference's
``VQA`` / ``VQAEval`` API over them (``compat``).

Each module is the port's own copy of its JAX-package counterpart
(``mcan_vqa_tpu/evals/``), numpy only; tests/test_torch_evals.py holds
each copy against its original.
"""
