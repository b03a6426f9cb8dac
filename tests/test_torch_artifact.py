"""Serving artifacts of the port (mcan_vqa_tpu_torch/artifact.py,
ops/library.py) on the CPU.

Every engine's artifact (``torch.export`` programs over the tree's tensor
leaves, the serving kernels as ``torch.ops.mcan.*`` custom ops whose CPU
implementation is the plain version) gives the live Predictor's
probabilities bit for bit in every bucket; the fused engines' programs
hold the ops, one node per kernel launch of the live forward; the live
Predictor makes no custom-op call. Against the JAX package: the port's
plain artifact within 1e-5 of JAX's ``load_artifact`` of the same weights
(JAX exports its plain engine for the CPU), the other engines within the
tolerances of tests/test_torch_parallel.py::test_mesh_predictor_matches_jax
(2e-2; int4 and q8aux 6e-2) of JAX's live Predictor. Weights come from a
seeded port ``MCANet`` carried into JAX by ``import_torch_state_dict``;
inputs are seeded numpy. Exports are computed once per module.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcan_vqa_tpu import artifact as jax_artifact
from mcan_vqa_tpu.api import Predictor as JaxPredictor
from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch import artifact
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import build_vocab
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import library
from mcan_vqa_tpu_torch.parallel import make_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCH = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=12, max_token=7, flat_mlp_size=24,
            flat_out_size=48)
CFG = Config(ff_size=256, **ARCH)
QUESTIONS = ["what color is the cat", "how many people are there",
             "is this a kitchen", ""]
I2A = {str(i): f"answer{i}" for i in range(20)}
L = CFG.layer
# engine -> Predictor keywords ("cal": the calibration batch) and its
# tolerance against JAX's live Predictor of the same keywords
ENGINES = {
    "fused": (dict(engine="fused", auto_calibrate=0), 2e-2),
    "level3": (dict(engine="fused", cal=True), 2e-2),
    "int4": (dict(engine="int4", cal=True), 6e-2),
    "int8": (dict(engine="int8"), 2e-2),
    "plain": (dict(engine="plain"), 1e-5),
    "q8aux": (dict(engine="fused", q8aux=True, cal=True), 6e-2),
}
# the op nodes of one forward (D = 64: level 1 runs the FFN int8, level 3
# every block product, level 5 the FFN and qkv int4; q8aux adds the cross
# k/v, both AttFlat merges and the head; full int8 every product)
GRAPH_OPS = {
    "fused": {"gemm_bias_act": 6 * L, "gemm_s8": 4 * L, "quantize_rows": 4 * L,
              "masked_attention": 3 * L, "residual_layernorm": 5 * L},
    "level3": {"gemm_s8": 10 * L, "quantize_rows": 10 * L,
               "masked_attention": 3 * L, "residual_layernorm": 5 * L},
    "int4": {"gemm_s4": 6 * L, "gemm_s8": 4 * L, "quantize_rows": 10 * L,
             "masked_attention": 3 * L, "residual_layernorm": 5 * L},
    "int8": {"gemm_s8": 11 * L + 8, "quantize_rows": 11 * L + 8,
             "masked_attention": 3 * L, "residual_layernorm": 5 * L},
    "plain": {},
    "q8aux": {"gemm_s8": 11 * L + 3, "quantize_rows": 11 * L + 3,
              "masked_attention": 3 * L, "residual_layernorm": 5 * L},
}
FORBIDDEN = ("mcan_vqa_tpu_torch.api", "mcan_vqa_tpu_torch.models.net",
             "mcan_vqa_tpu_torch.ops.serving", "mcan_vqa_tpu_torch.ops.quant",
             "mcan_vqa_tpu_torch.ops.sga_block", "jax", "mcan_vqa_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file's tests run (the suite runs
    files in parallel worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _features(n, seed):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(int(r), CFG.img_feat_size)))
            .astype(np.float32) for r in rng.integers(3, 13, n)]


def _questions(n):
    return [QUESTIONS[i % len(QUESTIONS)] for i in range(n)]


CAL = (_questions(4), _features(4, 1))


@pytest.fixture(scope="module")
def weights():
    vocab, emb = build_vocab(QUESTIONS, embed_dim=CFG.word_embed_size)
    net = MCANet(CFG, len(vocab), len(I2A), pretrained_emb=emb,
                 generator=torch.Generator().manual_seed(0))
    return net.state_dict(), vocab


def _kwargs(name):
    kw = dict(ENGINES[name][0])
    if kw.pop("cal", False):
        kw.update(act_calibration=CAL, auto_calibrate=0)
    return kw


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """engine -> (live Predictor, artifact dir, ArtifactPredictor), built
    on first use: the fused (level-1) engine over buckets 1 and 4, every
    other engine over its one bucket of 2."""
    sd, vocab = weights
    cache = {}

    def get(name):
        if name not in cache:
            buckets = dict(max_batch=4, latency_buckets=(1,)) \
                if name == "fused" else dict(max_batch=2)
            p = Predictor(CFG, sd, vocab, I2A, device="cpu", **buckets,
                          **_kwargs(name))
            path = str(tmp_path_factory.mktemp(name))
            p.export_artifact(path)
            cache[name] = (p, path, artifact.load_artifact(path,
                                                           device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(ENGINES))
def test_artifact_equals_live_predictor(exported, name):
    """The loaded artifact's probabilities, answers and top-k equal the
    live Predictor's bit for bit on ragged requests in every bucket."""
    p, path, ap = exported(name)
    assert ap.buckets == p.buckets and ap.max_batch == p.max_batch
    assert ap.routes == p.routes and ap.img_feat_size == CFG.img_feat_size
    for n in sorted({1, *p.buckets}):
        qs, fs = _questions(n), _features(n, 10 + n)
        np.testing.assert_array_equal(ap.predict_probs(qs, fs),
                                      p.predict_probs(qs, fs))
    qs, fs = _questions(2), _features(2, 3)
    assert ap.answer(qs, fs) == p.answer(qs, fs)
    assert ap.topk(qs, fs, k=3) == p.topk(qs, fs, k=3)
    with pytest.raises(ValueError, match="outside"):
        ap.predict_probs(_questions(p.max_batch + 1),
                         _features(p.max_batch + 1, 0))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["format_version"] == 1 and meta["engine"] == p.engine
    assert meta["program"] == "torch.export" and meta["device"] == "cpu"
    assert sorted(os.listdir(path)) == sorted(
        ["meta.json", "vocab.json", "answers.json", "params.npz"]
        + [f"forward_b{b}.pt2" for b in p.buckets])


def _graph_ops(ap, bucket):
    """The ``torch.ops.mcan.*`` nodes of the loaded program of a bucket."""
    ops = {}
    for node in ap._fns[bucket].graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "mcan."):
            name = str(node.target).split(".")[1]
            ops[name] = ops.get(name, 0) + 1
    return ops


@pytest.mark.parametrize("name", list(ENGINES))
def test_exported_graph_holds_the_kernel_ops(exported, name):
    """Each program holds one ``torch.ops.mcan.*`` node per kernel launch
    of the live forward on the card (none for the plain engine); running
    it calls each op once per node, and the live Predictor's eager
    forward calls none."""
    p, path, ap = exported(name)
    want = GRAPH_OPS[name]
    bucket = p.buckets[-1]
    assert _graph_ops(ap, bucket) == want
    qs, fs = _questions(bucket), _features(bucket, 5)
    library.reset_op_calls()
    K.reset_launches()
    p.predict_probs(qs, fs)
    assert library.op_calls() == {}
    assert K.launch_counts() == {}    # the CPU launches no kernel
    ap.predict_probs(qs, fs)
    assert library.op_calls() == want
    assert K.launch_counts() == {}


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g).to(dt)

    bf = torch.bfloat16
    xq, sx = K.quantize_rows(r(5, 64))
    wq = K.k_major(torch.randint(-127, 128, (64, 48), generator=g)
                   .to(torch.int8))
    wp = K.k_major(torch.randint(-128, 128, (64, 32), generator=g)
                   .to(torch.int8))
    s4 = r(1, 32).abs()
    xq4, _ = K.quantize_rows(r(5, 128), 2.0)
    pad = torch.zeros(2, 1, 1, 7, dtype=torch.bool)
    pad[1, 0, 0, 4:] = True
    return {
        "gemm_bias_act": (r(5, 64, dt=bf), r(64, 48, dt=bf), r(48), True,
                          bf),
        "gemm_ln": (r(5, 64, dt=bf), r(64, 32, dt=bf), None, r(5, 32),
                    r(32), r(32)),
        "quantize_rows": (r(5, 64), None),
        "quantize_rows_static": (r(5, 64), 0.5),
        "gemm_s8": (xq, wq, r(48).abs(), r(48), sx, None, True,
                    torch.float32, bf),
        "gemm_s8_static": (xq, wq, r(48).abs(), None, None, 0.1, False, bf,
                           None),
        "gemm_s4": (xq4, wp, s4, r(32), 0.5, True, torch.float32, None),
        "gemm_w4bf16": (r(5, 128, dt=bf), wp, s4, r(32), False, bf),
        "masked_attention": (r(2, 4, 6, 16), r(2, 4, 7, 16), r(2, 4, 7, 16),
                             pad, torch.float32),
        "residual_layernorm": (r(3, 4, 32), r(3, 4, 32), r(32), r(32),
                               r(32), torch.float32, bf),
        "attflat_pool": (r(10, 24, dt=bf), r(24, 2, dt=bf), r(2),
                         pad[:, :, :, :5].contiguous(), r(2, 5, 32)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck(case):
    """``torch.library.opcheck`` on CPU inputs: the schema, the fake
    implementation's shapes and dtypes against the real one, no alias of
    an input returned."""
    args = _opcheck_cases()[case]
    op = getattr(torch.ops.mcan, case.removesuffix("_static"))
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_wrappers_refuse_dropout_while_exporting():
    """The ops carry no dropout: a wrapper call with a keep-mask raises
    when it is exported."""
    class Drop(torch.nn.Module):
        def forward(self, a, w, mask):
            return K.gemm_bias_act(a, w, mask=mask, inv_keep=2.0)

    a, w = torch.ones(4, 8, dtype=torch.bfloat16), torch.ones(
        8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mask cannot be exported"):
        torch.export.export(Drop(), (a, w, torch.ones(4, 8,
                                                      dtype=torch.uint8)))


@pytest.fixture(scope="module")
def jax_side(weights):
    sd, vocab = weights
    jcfg = JConfig(use_glove=False, **ARCH).finalize()
    return jcfg, import_torch_state_dict(sd), vocab


def test_plain_artifact_matches_jax_artifact(exported, jax_side, tmp_path):
    """The port's plain artifact against JAX's artifact of the same
    weights (JAX exports its plain engine for the CPU): 1e-5."""
    jcfg, params, vocab = jax_side
    jp = JaxPredictor(jcfg, params, vocab, I2A, max_batch=2, engine="plain")
    jp.export_artifact(str(tmp_path), platforms=("cpu",))
    jap = jax_artifact.load_artifact(str(tmp_path))
    _, _, ap = exported("plain")
    qs, fs = _questions(2), _features(2, 7)
    np.testing.assert_allclose(ap.predict_probs(qs, fs),
                               jap.predict_probs(qs, fs), atol=1e-5)
    # the port's loader refuses JAX's directory, naming it
    with pytest.raises(ValueError, match="JAX artifact"):
        artifact.load_artifact(str(tmp_path), device="cpu")


@pytest.mark.parametrize("name", [n for n in ENGINES if n != "plain"])
def test_artifact_matches_jax_live_predictor(exported, jax_side, name):
    """Each engine's artifact against JAX's live Predictor of the same
    engine, weights and calibration batch."""
    jcfg, params, vocab = jax_side
    jp = JaxPredictor(jcfg, params, vocab, I2A, max_batch=2,
                      **_kwargs(name))
    _, _, ap = exported(name)
    qs, fs = _questions(2), _features(2, 8)
    np.testing.assert_allclose(ap.predict_probs(qs, fs),
                               jp.predict_probs(qs, fs),
                               atol=ENGINES[name][1])


def test_leaf_dtypes_round_trip(exported):
    """The stored leaves come back in their dtype, shape, strides and
    bits: bf16 (stored as uint16), f32, int8 and the nibble-packed int4
    words (int8, K-major)."""
    p, path, ap = exported("int4")
    _, _, _, leaves = artifact._flatten(*p._live[0]["base"][0])
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert {"bfloat16", "float32", "int8"} <= set(meta["leaf_dtypes"])
    with np.load(os.path.join(path, "params.npz")) as npz:
        stored = {str(npz[f"p{i}"].dtype) for i in range(len(leaves))}
    assert "uint16" in stored and "bfloat16" not in stored
    assert len(ap._leaves) == len(leaves)
    k_major = 0
    for got, want in zip(ap._leaves, leaves):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.stride() == want.stride()
        assert torch.equal(got, want)
        k_major += got.dim() == 2 and got.stride(0) == 1 \
            and got.shape[1] > 1
    assert k_major > 0      # the int8 / int4 weights keep their layout


def test_mesh_predictor_is_refused(weights, tmp_path):
    sd, vocab = weights
    pm = Predictor(CFG, sd, vocab, I2A, max_batch=2, engine="plain",
                   mesh=make_mesh({"data": 2}, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="mesh-built Predictor"):
        pm.export_artifact(str(tmp_path))


@pytest.mark.parametrize("edit,msg", [
    (dict(device="cuda"), "exported on 'cuda'"),
    (dict(format_version=2), "artifact format 2"),
    (dict(program="jax.export"), "artifact program")])
def test_loader_refusals(exported, tmp_path, edit, msg):
    """An artifact of another device, an unknown format version or
    another program kind is refused with a message."""
    _, path, _ = exported("plain")
    dst = tmp_path / "copy"
    shutil.copytree(path, dst)
    meta = json.load(open(dst / "meta.json"))
    meta.update(edit)
    json.dump(meta, open(dst / "meta.json", "w"))
    with pytest.raises(ValueError, match=msg):
        artifact.load_artifact(str(dst), device="cpu")


def test_loader_imports_no_model_code(exported):
    """A fresh process that loads the level-3 artifact and answers has
    none of the model code (api, models.net, ops.serving, ops.quant,
    ops.sga_block), JAX or the JAX package in sys.modules."""
    p, path, _ = exported("level3")
    qs, fs = _questions(2), _features(2, 9)
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import json, numpy as np, torch\n"
        "from mcan_vqa_tpu_torch.artifact import load_artifact\n"
        f"ap = load_artifact({path!r}, device='cpu')\n"
        f"fs = [np.asarray(f, np.float32) for f in {[f.tolist() for f in fs]!r}]\n"
        f"print(json.dumps(ap.answer({qs!r}, fs)))\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m in {FORBIDDEN!r}"
        " or m.split('.')[0] in ('jax', 'mcan_vqa_tpu'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    answers, bad = (json.loads(line) for line in
                    out.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert [tuple(a) for a in answers] == p.answer(qs, fs)
