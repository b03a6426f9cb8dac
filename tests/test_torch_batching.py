"""The port's micro-batching frontend (mcan_vqa_tpu_torch/batching.py) on
the CPU: JAX's tests/test_batching.py cases against the port's copy, over
the port's plain Predictor at tiny widths (the direct path as the oracle,
1e-5 as JAX's), and the dispatch / resolve overlap with stub predictors,
one of which hands back a torch tensor as the card's async dispatch does."""

import threading
import time

import numpy as np
import pytest
import torch

from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.batching import BatchingFrontend, FrontendOverloaded
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import build_vocab
from mcan_vqa_tpu_torch.models.net import MCANet

CFG = Config(hidden_size=32, layer=1, multi_head=4, ff_size=128,
             img_feat_size=16, img_feat_pad_size=8, max_token=6,
             flat_out_size=32, flat_mlp_size=16)
I2A = {str(i): a for i, a in enumerate(["yes", "no", "red", "blue", "2"])}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file's tests run (the suite runs
    files in parallel worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def predictor():
    tok, _ = build_vocab(["what color is the cat dog red blue"])
    net = MCANet(CFG, len(tok), len(I2A),
                 generator=torch.Generator().manual_seed(0))
    return Predictor(CFG, net.state_dict(), tok, I2A, max_batch=8,
                     latency_buckets=(1, 2), engine="plain", device="cpu")


def test_matches_direct_path(predictor):
    """Every coalesced answer equals the direct Predictor answer for the
    same (question, features) pair, regardless of grouping."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(6, 6, 16)).astype(np.float32)
    qs = ["what is this", "is the cat red", "what color",
          "is the dog blue", "what color is the cat", "red or blue"]
    direct = predictor.answer(qs, feats)
    with BatchingFrontend(predictor, max_wait_ms=20.0) as fe:
        futs = [fe.submit(q, f) for q, f in zip(qs, feats)]
        got = [f.result(timeout=60) for f in futs]
    for (a1, p1), (a2, p2) in zip(direct, got):
        assert a1 == a2
        assert abs(p1 - p2) < 1e-5
    assert fe.requests_served == 6


def test_top_k_future_resolves_to_list(predictor):
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(6, 16)).astype(np.float32)
    q = "what color is the cat"
    with BatchingFrontend(predictor, max_wait_ms=5.0) as fe:
        got3 = fe.submit(q, feat, top_k=3).result(timeout=60)
        got1 = fe.submit(q, feat).result(timeout=60)
    (want3,) = predictor.topk([q], feat[None], k=3)
    assert isinstance(got3, list) and len(got3) == 3
    for (a1, p1), (a2, p2) in zip(got3, want3):
        assert a1 == a2 and abs(p1 - p2) < 1e-5
    assert got1 == got3[0]  # top_k=1 keeps the scalar contract


def test_concurrent_callers_coalesce(predictor):
    """Many threads submitting at once produce fewer batches than
    requests, with every result correct."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(16, 6, 16)).astype(np.float32)
    results = {}
    with BatchingFrontend(predictor, max_wait_ms=50.0) as fe:
        barrier = threading.Barrier(16)

        def call(i):
            barrier.wait()
            results[i] = fe.answer("what color", feats[i], timeout=60)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert len(results) == 16
    direct = (predictor.answer(["what color"] * 8, feats[:8])
              + predictor.answer(["what color"] * 8, feats[8:]))
    for i, (a, p) in enumerate(direct):
        assert results[i][0] == a
        assert abs(results[i][1] - p) < 1e-5
    assert fe.batches_run < 16  # coalescing happened
    assert fe.mean_occupancy > 1.0


def test_respects_max_batch(predictor):
    """Groups never exceed max_batch even under a burst."""
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(10, 6, 16)).astype(np.float32)
    with BatchingFrontend(predictor, max_wait_ms=50.0, max_batch=4) as fe:
        futs = [fe.submit("what is this", f) for f in feats]
        for f in futs:
            f.result(timeout=60)
    assert fe.batches_run >= 3  # 10 requests / cap 4


def test_closed_frontend_rejects(predictor):
    fe = BatchingFrontend(predictor, max_wait_ms=0.0)
    fe.close()
    fe.close()  # idempotent
    with pytest.raises(RuntimeError):
        fe.submit("what", np.zeros((6, 16), np.float32))


def test_ragged_region_counts_coalesce(predictor):
    """Requests whose images have different region counts coalesce into
    one group (the predictor pads each) and match the direct padded
    path."""
    rng = np.random.default_rng(4)
    ragged = [rng.normal(size=(r, 16)).astype(np.float32)
              for r in (3, 8, 5, 6)]
    qs = ["what is this", "is the cat red", "what color", "red or blue"]
    padded = np.zeros((4, 8, 16), np.float32)
    for i, f in enumerate(ragged):
        padded[i, :f.shape[0]] = f
    direct = predictor.answer(qs, padded)
    with BatchingFrontend(predictor, max_wait_ms=50.0) as fe:
        futs = [fe.submit(q, f) for q, f in zip(qs, ragged)]
        got = [f.result(timeout=60) for f in futs]
    for (a1, p1), (a2, p2) in zip(direct, got):
        assert a1 == a2
        assert abs(p1 - p2) < 1e-5


def test_bad_item_in_group_isolated(predictor):
    """A malformed request sharing a group with good ones fails alone;
    its groupmates still get answers and the worker survives."""
    rng = np.random.default_rng(5)
    good_feat = rng.normal(size=(6, 16)).astype(np.float32)
    with BatchingFrontend(predictor, max_wait_ms=500.0) as fe:
        f_ok1 = fe.submit("what color", good_feat)
        f_bad3d = fe.submit("what", np.zeros((2, 3, 4), np.float32))
        f_badw = fe.submit("what", np.zeros((6, 7), np.float32))
        f_ok2 = fe.submit("is the cat red", good_feat)
        ans1 = f_ok1.result(timeout=60)
        ans2 = f_ok2.result(timeout=60)
        with pytest.raises(ValueError):
            f_bad3d.result(timeout=60)
        with pytest.raises(ValueError, match="width 7"):
            f_badw.result(timeout=60)
        assert fe.batches_run == 1  # all four rode one group
    direct = predictor.answer(["what color", "is the cat red"],
                              np.stack([good_feat, good_feat]))
    assert ans1[0] == direct[0][0] and ans2[0] == direct[1][0]


def test_bad_request_fails_future_not_loop(predictor):
    """A malformed request fails its own future; the worker survives and
    keeps serving."""
    with BatchingFrontend(predictor, max_wait_ms=0.0) as fe:
        bad = fe.submit("what", np.zeros((3, 3, 3, 3), np.float32))
        with pytest.raises(ValueError):
            bad.result(timeout=60)
        ans, prob = fe.submit("what color",
                              np.zeros((6, 16), np.float32)).result(60)
        assert isinstance(ans, str) and 0.0 <= prob <= 1.0


def test_max_queue_sheds_load():
    """With max_queue set, submit() raises FrontendOverloaded once that
    many requests are waiting; in-flight work still completes."""
    entered = threading.Event()
    release = threading.Event()

    class SlowPredictor:
        ix_to_ans = {"0": "a", "1": "b"}
        max_batch = 1   # one request per group
        img_feat_size = 4

        def predict_probs(self, qs, fs):
            entered.set()
            assert release.wait(timeout=60)
            out = np.zeros((len(qs), 2), np.float32)
            out[:, 1] = 1.0
            return out

    feat = np.zeros((2, 4), np.float32)
    fe = BatchingFrontend(SlowPredictor(), max_wait_ms=0.0, max_queue=1)
    try:
        f_a = fe.submit("a", feat)            # dequeued, in flight
        assert entered.wait(timeout=60)
        f_b = fe.submit("b", feat)            # sits in the queue
        with pytest.raises(FrontendOverloaded, match="overloaded"):
            fe.submit("c", feat)              # queue full -> shed
        release.set()
        assert f_a.result(timeout=60) == ("b", 1.0)
        assert f_b.result(timeout=60) == ("b", 1.0)
    finally:
        release.set()
        fe.close()


def test_latency_metrics(predictor):
    """latency_ms() reports submit -> resolve quantiles over served
    requests; empty before any traffic, populated and ordered after."""
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(6, 16)).astype(np.float32)
    with BatchingFrontend(predictor, max_wait_ms=5.0) as fe:
        assert fe.latency_ms()["count"] == 0
        for _ in range(3):
            fe.answer("what color", feat, timeout=60)
        lat = fe.latency_ms()
        fe.reset_stats()
        assert fe.latency_ms()["count"] == 0 and fe.batches_run == 0
    assert lat["count"] == 3
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert lat["mean"] > 0


class _LazyResult:
    """A result that takes 0.25 s to materialize, recording when."""

    def __init__(self, n, tag, events):
        self.n, self.tag, self.events = n, tag, events

    def __array__(self, dtype=None, copy=None):
        time.sleep(0.25)
        self.events.append(("materialized", self.tag, time.monotonic()))
        out = np.zeros((self.n, 4), np.float32)
        out[:, 1] = 1.0  # answer ix 1
        return out


@pytest.mark.parametrize("result", ["array_like", "tensor"])
def test_dispatch_overlaps_resolution(result):
    """The frontend pipelines: group N+1 is dispatched while group N is
    still materializing. "tensor": the stub hands back a torch tensor, as
    ``predict_probs_async`` does, and the resolver's copy to the host
    (``device.to_host``) is the slow step."""
    events = []

    class SlowTensor(torch.Tensor):
        """A tensor whose rows reach the host 0.25 s late (``cpu``), as a
        forward's output does while the card computes it."""

        def cpu(self, *args, **kwargs):
            time.sleep(0.25)
            events.append(("materialized", "t", time.monotonic()))
            return self.as_subclass(torch.Tensor).cpu(*args, **kwargs)

    class FakePredictor:
        ix_to_ans = {"0": "a", "1": "b", "2": "c", "3": "d"}
        max_batch = 4
        img_feat_size = 16

        def predict_probs_async(self, qs, fs):
            events.append(("dispatched", len(events), time.monotonic()))
            if result == "array_like":
                return _LazyResult(len(qs), "g%d" % len(events),
                                   events), len(qs)
            out = torch.zeros((len(qs), 4))
            out[:, 1] = 1.0
            return out.as_subclass(SlowTensor), len(qs)

    feat = np.zeros((5, 16), np.float32)
    with BatchingFrontend(FakePredictor(), max_wait_ms=0.0) as fe:
        f1 = fe.submit("one", feat)
        time.sleep(0.05)  # let group 1 dispatch + start resolving
        f2 = fe.submit("two", feat)
        assert f1.result(timeout=30) == ("b", 1.0)
        assert f2.result(timeout=30) == ("b", 1.0)
    dispatches = [e for e in events if e[0] == "dispatched"]
    materials = [e for e in events if e[0] == "materialized"]
    assert len(dispatches) == 2 and len(materials) == 2
    # group 2 dispatched BEFORE group 1 finished materializing
    assert dispatches[1][2] < materials[0][2]
