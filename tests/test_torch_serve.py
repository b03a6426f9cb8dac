"""The port's HTTP server (mcan_vqa_tpu_torch/cli/serve.py) on the CPU,
held against the JAX package's (mcan_vqa_tpu/cli/serve.py): both servers,
each over its plain engine on the same weights (a seeded port ``MCANet``
carried into JAX by ``import_torch_state_dict``), get the same bodies and
give the same status codes, keys, answers and error messages, with
probabilities within 1e-5 (the plain engines' gap,
tests/test_torch_parallel.py). Then the pieces only the port's CLI
drives: the warm-up over every bucket with the online calibration paused,
``--synthetic``, ``--artifact`` and the refused flag combinations."""

import base64
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.api import Predictor as JaxPredictor
from mcan_vqa_tpu.batching import FrontendOverloaded as JaxOverloaded
from mcan_vqa_tpu.cli import serve as jax_serve
from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.batching import FrontendOverloaded
from mcan_vqa_tpu_torch.cli import serve
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import build_vocab
from mcan_vqa_tpu_torch.models.net import MCANet

ARCH = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=12, max_token=7, flat_mlp_size=24,
            flat_out_size=48)
CFG = Config(ff_size=256, **ARCH)
F = CFG.img_feat_size
I2A = {str(i): f"answer{i}" for i in range(20)}
TINY = ["--hidden_size", "32", "--layer", "1", "--multi_head", "4",
        "--img_feat_size", "16", "--img_feat_pad_size", "8", "--max_token",
        "6", "--flat_out_size", "32", "--flat_mlp_size", "16", "--device",
        "cpu"]
PROB_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file's tests run (the suite runs
    files in parallel worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def predictors():
    vocab, emb = build_vocab(["what color is the cat dog red blue"],
                             embed_dim=CFG.word_embed_size)
    sd = MCANet(CFG, len(vocab), len(I2A), pretrained_emb=emb,
                generator=torch.Generator().manual_seed(0)).state_dict()
    port = Predictor(CFG, sd, vocab, I2A, max_batch=4, latency_buckets=(1,),
                     engine="plain", device="cpu")
    jcfg = JConfig(use_glove=False, **ARCH).finalize()
    jax_p = JaxPredictor(jcfg, import_torch_state_dict(sd), vocab, I2A,
                         max_batch=4, latency_buckets=(1,), engine="plain")
    return port, jax_p


class _Server:
    """make_server's pair run on a thread; closed by ``close``."""

    def __init__(self, make_server, predictor, **kw):
        self.srv, self.frontend = make_server(predictor, port=0, **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = self.srv.server_address[:2]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.frontend.close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def servers(predictors):
    port, jax_p = predictors
    pair = [_Server(serve.make_server, port, max_wait_ms=20.0),
            _Server(jax_serve.make_server, jax_p, max_wait_ms=20.0)]
    yield pair
    for s in pair:
        s.close()


def _send(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body=body,
                 headers=headers or {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _feat(seed, rows=5, width=F):
    return np.random.default_rng(seed).normal(
        size=(rows, width)).astype(np.float32)


def _b64(feat):
    return {"b64": base64.b64encode(feat.tobytes()).decode(),
            "shape": list(feat.shape)}


def _assert_same(got, want):
    """Two JSON replies alike: the same keys and strings, probabilities
    within PROB_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= PROB_TOL
    else:
        assert got == want


BODIES = {
    "single_list": {"question": "what color is the cat",
                    "image_feature": _feat(0).tolist()},
    "single_b64": {"question": "is the dog red",
                   "image_feature": _b64(_feat(1, rows=7))},
    "top_k_1": {"question": "what color is the dog",
                "image_feature": _feat(2).tolist(), "top_k": 1},
    "top_k_5": {"question": "what color is the dog",
                "image_feature": _b64(_feat(2)), "top_k": 5},
    "batch": {"requests": [
        {"question": "what is this", "image_feature": _feat(3, 3).tolist()},
        {"question": "bad", "image_feature": [[1.0] * 7]},   # width 7
        {"question": "what color", "image_feature": _b64(_feat(4, 12))},
        {"question": "", "image_feature": _feat(3, 3).tolist()},
        {"question": "red or blue", "image_feature": _feat(5).tolist(),
         "top_k": 5},
        {"question": "blue", "image_feature": _feat(6).tolist(),
         "top_k": 33}]},
    "missing_feature": {"question": "hi"},
    "one_dim_feature": {"question": "hi", "image_feature": [1.0, 2.0]},
    "non_finite_list": {"question": "what",
                        "image_feature": [[0.0] * F, [float("nan")] + [0.0]
                                          * (F - 1)]},
    "non_finite_b64": {"question": "what", "image_feature": _b64(
        np.full((2, F), np.inf, np.float32))},
    "bad_b64": {"question": "hi",
                "image_feature": {"b64": "!!!", "shape": [1, F]}},
    "short_b64": {"question": "hi", "image_feature": {
        "b64": base64.b64encode(b"\x00" * 8).decode(), "shape": [1, F]}},
    "empty_batch": {"requests": []},
    "top_k_33": {"question": "q", "image_feature": [[0.0] * F],
                 "top_k": 33},
    "top_k_bool": {"question": "q", "image_feature": [[0.0] * F],
                   "top_k": True},
}
RAW = {"bad_json": b"{not json"}


@pytest.mark.parametrize("name", list(BODIES) + list(RAW))
def test_answers_as_the_jax_server(servers, name):
    """POST /v1/answer: the same status, keys, answers and errors from
    both servers, probabilities within 1e-5."""
    body = RAW.get(name) or json.dumps(BODIES[name]).encode()
    (s_port, got), (s_jax, want) = (_send(s.addr, "POST", "/v1/answer",
                                          body) for s in servers)
    assert s_port == s_jax
    _assert_same(got, want)
    if name.startswith(("single", "top_k_1", "top_k_5")):
        assert s_port == 200 and "answer" in got
    elif name == "batch":
        assert s_port == 200 and ["error" in r for r in got["results"]] \
            == [False, True, False, True, False, True]
    else:
        assert s_port == 400 and "error" in got


@pytest.mark.parametrize("method,path", [
    ("GET", "/healthz"), ("GET", "/nope"), ("POST", "/nope")])
def test_routes_as_the_jax_server(servers, method, path):
    body = b'{"x": 1}' if method == "POST" else None
    (s_port, got), (s_jax, want) = (_send(s.addr, method, path, body)
                                    for s in servers)
    assert s_port == s_jax == (200 if path == "/healthz" else 404)
    assert got == want


def test_stats_as_the_jax_server(servers, predictors):
    (s_port, got), (s_jax, want) = (_send(s.addr, "GET", "/stats")
                                    for s in servers)
    assert s_port == s_jax == 200
    assert set(got) == set(want)
    for key in ("max_batch", "img_feat_size", "engine", "routes"):
        assert got[key] == want[key]
    assert got["calibration"]["state"] == want["calibration"]["state"] \
        == "off"
    assert got["requests_served"] == got["latency_ms"]["count"] > 0


def test_concurrent_posts_coalesce(servers, predictors):
    """Parallel single-question POSTs ride the micro-batcher: every
    answer is the direct Predictor's, in no more batches than
    requests."""
    port = predictors[0]
    addr = servers[0].addr
    _, before = _send(addr, "GET", "/stats")
    feats = [_feat(20 + i) for i in range(6)]
    results = [None] * 6

    def post(i):
        results[i] = _send(addr, "POST", "/v1/answer", json.dumps({
            "question": "what color is the cat",
            "image_feature": feats[i].tolist()}).encode())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    direct = port.answer(["what color is the cat"] * 4, feats[:4]) \
        + port.answer(["what color is the cat"] * 2, feats[4:])
    for (status, out), (ans, prob) in zip(results, direct):
        assert status == 200 and out["answer"] == ans
        assert abs(out["prob"] - prob) < 1e-6
    _, after = _send(addr, "GET", "/stats")
    assert after["requests_served"] - before["requests_served"] == 6
    assert after["batches_run"] - before["batches_run"] <= 6


def test_overload_is_503_as_the_jax_server(predictors):
    """A FrontendOverloaded from submit() is 503 for a single request and
    a per-item error inside a batch, on both servers."""
    replies = []
    for make, p, error in (
            (serve.make_server, predictors[0], FrontendOverloaded),
            (jax_serve.make_server, predictors[1], JaxOverloaded)):
        srv = _Server(make, p, max_wait_ms=0.0)

        def overloaded(*a, error=error, **k):
            raise error("frontend overloaded: test")

        srv.frontend.submit = overloaded
        try:
            payload = {"question": "q", "image_feature": [[0.0] * F]}
            replies.append([
                _send(srv.addr, "POST", "/v1/answer",
                      json.dumps(payload).encode()),
                _send(srv.addr, "POST", "/v1/answer",
                      json.dumps({"requests": [payload]}).encode())])
        finally:
            srv.close()
    assert replies[0] == replies[1]
    (single, out), (batch, res) = replies[0]
    assert single == 503 and "overloaded" in out["error"]
    assert batch == 200 and "overloaded" in res["results"][0]["error"]


def _post_raw(addr, headers, body=b""):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.putrequest("POST", "/v1/answer")
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    closing = resp.getheader("Connection")
    conn.close()
    return resp.status, out, closing


def test_body_cap_and_content_length_as_the_jax_server(predictors):
    """A body over the cap is 413 before it is read (and the connection
    is closed, announced); a garbled Content-Length is 400."""
    big = json.dumps({"question": "q",
                      "image_feature": [[0.0] * 64]}).encode()
    replies = []
    for make, p in ((serve.make_server, predictors[0]),
                    (jax_serve.make_server, predictors[1])):
        srv = _Server(make, p, max_body_bytes=64)
        try:
            replies.append([
                _post_raw(srv.addr, {"Content-Type": "application/json",
                                     "Content-Length": str(len(big))},
                          big),
                _post_raw(srv.addr, {"Content-Type": "application/json",
                                     "Content-Length": "banana"})])
        finally:
            srv.close()
    assert replies[0] == replies[1]
    (s413, out413, closing), (s400, out400, _) = replies[0]
    assert s413 == 413 and "64-byte limit" in out413["error"]
    assert closing == "close"
    assert s400 == 400 and "Content-Length" in out400["error"]


def test_warmup_covers_every_bucket_with_calibration_paused():
    """warmup() runs one forward per bucket with the online calibration
    paused: the dummies are not collected; live traffic through the HTTP
    stack then fills the buffer and the engine swaps to level 3."""
    p = serve.build_predictor(serve.parse_args(
        ["--synthetic", "--max_batch", "4", "--latency_buckets", "1,2",
         "--auto_calibrate", "3"] + TINY))
    assert p.buckets == (1, 2, 4)
    seen = []
    original = p.forward_padded

    def spy(img, ques):
        seen.append(img.shape[0])
        return original(img, ques)

    p.forward_padded = spy
    serve.warmup(p)
    assert seen == [1, 2, 4]
    assert p.calibration == {"state": "collecting", "samples": 0,
                             "target": 3}
    srv = _Server(serve.make_server, p, max_wait_ms=5.0)
    try:
        for i in range(3):
            status, out = _send(srv.addr, "POST", "/v1/answer", json.dumps(
                {"question": "what color is the cat",
                 "image_feature": _feat(i, 6, 16).tolist()}).encode())
            assert status == 200, out
        assert p.wait_calibrated(timeout=300)
        status, stats = _send(srv.addr, "GET", "/stats")
        assert stats["calibration"]["state"] == "calibrated"
        assert stats["engine"] == "fused"
    finally:
        srv.close()


def test_synthetic_and_artifact_serving(tmp_path):
    """--synthetic builds a seeded MCANet's Predictor (the same weights
    from the same --seed); its exported artifact served by --artifact
    answers as it does."""
    args = ["--synthetic", "--max_batch", "2", "--latency_buckets", "",
            "--auto_calibrate", "0", "--seed", "3"] + TINY
    p = serve.build_predictor(serve.parse_args(args))
    again = serve.build_predictor(serve.parse_args(args))
    feat = _feat(9, 6, 16)
    assert np.array_equal(p.predict_probs(["what color"], [feat]),
                          again.predict_probs(["what color"], [feat]))
    p.export_artifact(str(tmp_path))
    ap = serve.build_predictor(serve.parse_args(
        ["--artifact", str(tmp_path), "--device", "cpu"]))
    serve.warmup(ap)
    srv = _Server(serve.make_server, ap, max_wait_ms=1.0)
    try:
        status, out = _send(srv.addr, "POST", "/v1/answer", json.dumps(
            {"question": "what color", "image_feature": feat.tolist()})
            .encode())
        _, stats = _send(srv.addr, "GET", "/stats")
    finally:
        srv.close()
    (ans, prob), = p.answer(["what color"], [feat])
    assert status == 200 and out == {"answer": ans, "prob": prob}
    assert stats["engine"] == "artifact" and stats["routes"] == {"2": "base"}


@pytest.mark.parametrize("argv,msg", [
    (["--artifact", "/nonexistent", "--calibrate", "x.npz"],
     "--calibrate does not apply to --artifact"),
    (["--artifact", "/nonexistent", "--q8aux"],
     "--q8aux does not apply to --artifact"),
    (["--ckpt_path", "/nonexistent/orbax_dir", "--vocab_json", "VOCAB"],
     "only reference pickles"),
    (["--ckpt_path", "/nonexistent/epoch1.pkl"], "needs --vocab_json"),
    ([], "one of --artifact / --ckpt_path / --synthetic")])
def test_refused_flags(tmp_path, argv, msg):
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({"PAD": 0, "UNK": 1}))
    argv = [str(vocab) if a == "VOCAB" else a for a in argv]
    with pytest.raises(SystemExit, match=msg):
        serve.build_predictor(serve.parse_args(argv + TINY))


def test_calibrate_flag(tmp_path):
    """--calibrate NPZ (ragged object-array features) serves the level-3
    engine at once; an npz without the arrays is refused."""
    rng = np.random.default_rng(3)
    feats = np.empty(3, dtype=object)
    for i, r in enumerate((8, 5, 2)):
        feats[i] = rng.normal(size=(r, 16)).astype(np.float32)
    npz = tmp_path / "cal.npz"
    np.savez(npz, questions=np.array(
        ["what color is the cat", "is the dog red", "what is blue"]),
        features=feats)
    knobs = ["--synthetic", "--engine", "fused", "--max_batch", "2",
             "--latency_buckets", ""] + TINY
    p = serve.build_predictor(serve.parse_args(knobs + ["--calibrate",
                                                        str(npz)]))
    assert p.calibration["state"] == "calibrated" and p.act_scales
    bad = tmp_path / "bad.npz"
    np.savez(bad, questions=np.array(["q"]))
    with pytest.raises(SystemExit, match="missing arrays"):
        serve.build_predictor(serve.parse_args(knobs + ["--calibrate",
                                                        str(bad)]))
