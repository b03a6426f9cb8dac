"""Host-side data of the port: vocabulary, answer dictionary and targets,
request padding, region features and their packed cache, the VQA-v2 and
synthetic datasets, the MIMIC-CXR dataset and its synthetic stand-in, the
per-label train-data filter and the batch loader.

Every module here but ``vqa_files`` and ``mimic_files`` is the port's own
copy of its JAX-package counterpart (``mcan_vqa_tpu/data/{text,answers,
features,vqa_dataset,pipeline,mimic,filter_train_data}.py``,
``mcan_vqa_tpu/request_prep.py``); the port imports nothing of
``mcan_vqa_tpu``. ``vqa_files`` and ``mimic_files`` write miniature
datasets in VQA-v2's and MIMIC-CXR's own file formats. The names below
are the ones the rest of the port and its callers use.
"""

from mcan_vqa_tpu_torch.data.answers import load_answer_dict, topk_answers
from mcan_vqa_tpu_torch.data.request_prep import (pad_to_bucket,
                                                  prep_request_inputs)
from mcan_vqa_tpu_torch.data.text import build_vocab

__all__ = ["build_vocab", "load_answer_dict", "topk_answers",
           "pad_to_bucket", "prep_request_inputs"]
