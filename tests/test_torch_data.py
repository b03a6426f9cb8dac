"""The port's copies of the JAX package's host modules
(mcan_vqa_tpu_torch/data/) against the originals on the same inputs:
vocabulary, token ids, answer dictionary, request padding, the synthetic
training set and the batch loader. All exact: the copies are the same
numpy code."""

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.data import answers as janswers
from mcan_vqa_tpu.data import features as jfeatures
from mcan_vqa_tpu.data import text as jtext
from mcan_vqa_tpu.data.pipeline import BatchLoader as JBatchLoader
from mcan_vqa_tpu.data.vqa_dataset import SyntheticVQADataset as JSynthetic
from mcan_vqa_tpu.request_prep import pad_to_bucket as jpad_to_bucket
from mcan_vqa_tpu.request_prep import \
    prep_request_inputs as jprep_request_inputs
from mcan_vqa_tpu_torch import data as tdata
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import answers as tanswers
from mcan_vqa_tpu_torch.data import features as tfeatures
from mcan_vqa_tpu_torch.data import text as ttext
from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset

QUESTIONS = ["What color is the cat?", "How many people are in the "
             "picture?", "is this a kitchen", "What's on the table-top/desk?",
             "", "Is the man's hat red, or blue?!"]
SMALL = dict(word_embed_size=16, img_feat_pad_size=12, img_feat_size=8,
             max_token=6)


@pytest.mark.parametrize("q", QUESTIONS)
def test_clean_question_matches(q):
    assert ttext.clean_question(q) == jtext.clean_question(q)


def test_vocab_and_token_ids_match():
    tv, temb = ttext.build_vocab(QUESTIONS, embed_dim=16)
    jv, jemb = jtext.build_vocab(QUESTIONS, embed_dim=16)
    assert tv == jv
    np.testing.assert_array_equal(temb, jemb)
    for max_token in (4, 14):
        np.testing.assert_array_equal(
            ttext.encode_questions(QUESTIONS, tv, max_token),
            jtext.encode_questions(QUESTIONS, jv, max_token))


def test_answer_dict_and_topk_match():
    t_a2i, t_i2a = tanswers.load_answer_dict()
    j_a2i, j_i2a = janswers.load_answer_dict()
    assert t_a2i == j_a2i and t_i2a == j_i2a and len(t_i2a) == 3129
    row = np.random.default_rng(0).random(3129).astype(np.float32)
    for k in (1, 5, 3129, 5000):
        assert tanswers.topk_answers(row, t_i2a, k) == \
            janswers.topk_answers(row, j_i2a, k)


def test_request_prep_matches():
    vocab, _ = ttext.build_vocab(QUESTIONS)
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(r, 8)).astype(np.float32)
             for r in (3, 12, 20, 1, 7, 12)]
    t_ques, t_img = tdata.prep_request_inputs(QUESTIONS, feats, vocab, 6, 12)
    j_ques, j_img = jprep_request_inputs(QUESTIONS, feats, vocab, 6, 12)
    np.testing.assert_array_equal(t_ques, j_ques)
    np.testing.assert_array_equal(t_img, j_img)
    for target in (6, 8):
        for a, b in zip(tdata.pad_to_bucket(t_img, t_ques, target),
                        jpad_to_bucket(j_img, j_ques, target)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfeatures.pad_img_feat(feats[2], 12),
                                  jfeatures.pad_img_feat(feats[2], 12))


def _datasets(size=10):
    tcfg = Config(**SMALL)
    jcfg = JConfig()
    jcfg.merge_dict(SMALL)
    kw = dict(size=size, token_size=30, answer_size=7, seed=3)
    return (SyntheticVQADataset(tcfg, **kw),
            JSynthetic(jcfg, run_mode="train", **kw))


def test_synthetic_dataset_matches():
    tds, jds = _datasets()
    assert len(tds) == len(jds) and tds.ans_size == jds.ans_size \
        and tds.token_size == jds.token_size
    np.testing.assert_array_equal(tds.pretrained_emb, jds.pretrained_emb)
    for i in range(len(tds)):
        te, je = tds.example(i), jds.example(i)
        assert set(te) == set(je)
        for k in te:
            np.testing.assert_array_equal(te[k], je[k])


def test_batch_loader_matches_order_and_batches():
    tds, jds = _datasets(size=11)
    tl = BatchLoader(tds, 4, "cpu", seed=5)
    jl = JBatchLoader(jds, 4, seed=5, num_workers=1)
    assert len(tl) == len(jl) == 2       # drop_last
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        for tb, jb in zip(tl, jl):
            for k in ("img", "ques", "target"):
                assert isinstance(tb[k], torch.Tensor)
                np.testing.assert_array_equal(tb[k].numpy(), jb[k])
