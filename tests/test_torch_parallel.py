"""The port's data and tensor parallelism (mcan_vqa_tpu_torch/parallel/,
the mesh wiring of the train step, Trainer, loader and Predictor) against
the JAX package's (mcan_vqa_tpu/parallel/, tests/test_parallel.py,
__graft_entry__.dryrun_multichip) on the 8-device virtual CPU mesh that
conftest gives JAX.

One group of 4 gloo ranks (tests/torch_parallel_ranks.py, a FileStore in
a temp directory, one torch thread each) runs every multi-rank case once;
the ranks start with the module and the JAX oracles are computed while
they run. Weights come from a seeded port ``MCANet``
carried into JAX by ``import_torch_state_dict``; inputs are seeded numpy.

Tolerances. The mesh steps against JAX's ``jit_train_step`` on the
matching mesh at JAX's gates (test_parallel.py:85-118): loss 1e-4
relative, each gradient leaf 2e-4 of its scale floored at 1e-2, both
sides with f32 operands (JAX's compute_dtype="float32", the port's
``operand_dtype``): with bf16 operands every gradient leaf is a bf16
rounding of a partial sum, and another split of the sum moves it by up to
2^-8 of the leaf (measured 5.2e-3 of scale at dp2 against one process).
The fused-DP penalty parity (test_parallel.py:120-150): the data group's
wiring at reg_factor 1e-3 against JAX's ``shardmap_train_step`` at loss
1e-5 and JAX's gradient gate; the fused engine per data rank against the
port's own one-process fused steps: the sum of the two ranks' rows
stepped alone within 1e-6 of scale (it is that sum), one step over the
whole batch at loss 1e-6 and gradients 5e-3 of scale (its blocks' bf16
roundings: the CPU's matmul takes another path at another row count, and
a rounded input moves; measured 2.1e-3). The mesh
Predictor: ``dryrun_multichip``'s tolerances against JAX's mesh Predictor
(1e-5 plain, 2e-2 fused and calibrated, 6e-2 int4 and q8aux), and 1e-6
against the port's mesh-less Predictor of the same engine.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from mcan_vqa_tpu.api import Predictor as JaxPredictor
from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.data import text
from mcan_vqa_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.parallel import mesh as jmesh
from mcan_vqa_tpu.parallel import sharding as jshd
from mcan_vqa_tpu.train import checkpoint as jckpt
from mcan_vqa_tpu.train.step import make_train_step as jax_train_step
from mcan_vqa_tpu.train.train_state import TrainState as JTrainState
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
from mcan_vqa_tpu_torch.models.net import ClassifierNet, MCANet
from mcan_vqa_tpu_torch.parallel import make_mesh, param_spec
from mcan_vqa_tpu_torch.train.checkpoint import (_torch_key,
                                                 reference_param_keys,
                                                 state_dict_from_params)

import torch_parallel_ranks as ranks_mod  # noqa: E402 (tests/ is on sys.path)

HERE = Path(__file__).resolve().parent
WORLD = 4
RANKS_TIMEOUT = 240


# ---------------------------------------------------------------------------
# the rank group
# ---------------------------------------------------------------------------

class RankGroup:
    """The 4 rank processes, started once; ``results()`` waits for them."""

    def __init__(self, out: Path):
        self.out = out
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = []
        for r in range(WORLD):
            with open(out / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "torch_parallel_ranks.py"),
                     "--rank", str(r), "--world", str(WORLD), "--out",
                     str(out)], stdout=log, stderr=subprocess.STDOUT,
                    env=env))
        self._done = None

    def results(self) -> Path:
        if self._done is None:
            t0 = time.time()
            rcs = []
            for p in self.procs:
                try:
                    rcs.append(p.wait(timeout=max(
                        1.0, RANKS_TIMEOUT - (time.time() - t0))))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    rcs.append("timeout")
            logs = "\n".join((self.out / f"rank{r}.log").read_text()[-3000:]
                             for r in range(WORLD))
            self._done = (rcs, logs)
        rcs, logs = self._done
        assert rcs == [0] * WORLD, f"rank exit codes {rcs}\n{logs}"
        return self.out


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """Started before the module's first test, so that every JAX oracle
    of the module is computed while the ranks run."""
    g = RankGroup(tmp_path_factory.mktemp("ranks"))
    yield g
    for p in g.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _compare_grads(want, got, tol, label):
    """Each leaf within ``tol`` of its scale, the scale floored at 1e-2
    (test_parallel.py:96-105) -> the worst ratio."""
    worst = 0.0
    for k, a in want.items():
        b = got[k]
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        scale = max(float(np.abs(a).max()), 1e-2)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, f"{label} {k}: {err:.3e} of scale > {tol}"
        worst = max(worst, err)
    return worst


def _port_grads(npz):
    return {k[len("grad/"):]: npz[k] for k in npz.files
            if k.startswith("grad/")}


def _step_params():
    """The JAX tree of the seeded port MCANet every rank starts from."""
    cfg = ranks_mod.step_config(1, 0.0)
    return jckpt.import_torch_state_dict(
        ranks_mod.step_model(cfg).state_dict())


def _jax_config(accu):
    d = ranks_mod.TINY
    return JConfig(hidden_size=d["hidden_size"], ff_size=d["ff_size"],
                   layer=d["layer"],
                   img_feat_size=d["img_feat_size"],
                   flat_out_size=d["flat_out_size"],
                   flat_mlp_size=d["flat_mlp_size"],
                   multi_head=d["multi_head"], batch_size=ranks_mod.BATCH,
                   grad_accu_steps=accu, dropout_rate=0.0,
                   compute_dtype="float32", use_glove=False).finalize()


def _jax_mesh_step(shape, accu, reg=0.0, shardmap=False):
    """One SGD(1.0) step of JAX's plain model on ``shape`` -> (gradients
    by the port's keys, loss): ``jit_train_step``, or ``shardmap_train_step``
    with ``data_axis`` (the fused-DP wiring)."""
    cfg = _jax_config(accu)
    model = build_mcan(cfg, token_size=ranks_mod.TOKENS,
                       answer_size=ranks_mod.ANSWERS)
    params = _step_params()
    tx = optax.sgd(1.0)
    state = JTrainState.create(params, tx, seed=0)
    mesh = jmesh.make_mesh(shape)
    batch = ranks_mod.step_batch()
    step = jax_train_step(model, tx, grad_accu_steps=accu, reg_factor=reg,
                          data_axis="data" if shardmap else None)
    jstep = (jshd.shardmap_train_step(step, mesh, donate=False) if shardmap
             else jshd.jit_train_step(step, mesh, state, donate=False))
    new, metrics = jstep(jshd.shard_state(mesh, state),
                         jshd.shard_batch(mesh, batch))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                         jax.device_get(new.params))
    return ({k: v.numpy() for k, v in state_dict_from_params(grads).items()},
            float(metrics["loss"]))


# ---------------------------------------------------------------------------
# the sharding rule and the mesh's checks
# ---------------------------------------------------------------------------

def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class _Key:
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("net", ["MCANet", "ClassifierNet"])
def test_param_spec_matches_jax(net):
    """``param_spec`` on every state-dict key equals JAX's ``param_pspec``
    on the matching flax path, a transposed kernel's spec reversed."""
    cfg = Config(**ranks_mod.TINY)
    g = torch.Generator().manual_seed(0)
    model = (MCANet(cfg, 30, 10, generator=g) if net == "MCANet"
             else ClassifierNet(cfg, 14, generator=g))
    sd = model.state_dict()
    tree = jckpt.import_torch_state_dict(sd)
    seen = set()
    n_sharded = 0
    for path, arr in _flat_paths(tree):
        key, transpose = _torch_key(path)
        want = tuple(jshd.param_pspec(tuple(_Key(p) for p in path)))
        want = want + (None,) * (arr.ndim - len(want))
        if transpose:
            want = want[::-1]
        got = param_spec(key)
        got = got + (None,) * (sd[key].dim() - len(got))
        assert got == want, (key, got, want)
        seen.add(key)
        n_sharded += "model" in got
    assert seen == set(sd)
    assert n_sharded > 0


@pytest.mark.parametrize("shape", [
    {"dat": 2}, {"model": 0}, {"data": 0}, {"data": 5, "model": 2},
    {"data": -1, "model": 3}])
def test_make_mesh_errors_match_jax(shape):
    """The JAX mesh's assertion messages, as ValueErrors, over 8 devices
    (the port's serving form lists them)."""
    with pytest.raises(AssertionError) as jerr:
        jmesh.make_mesh(shape)
    with pytest.raises(ValueError) as terr:
        make_mesh(shape, devices=["cpu"] * 8)
    if shape != {"data": -1, "model": 3}:   # JAX's message is (n, tp)
        assert str(terr.value) == str(jerr.value)


def test_init_distributed_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL takes one device per rank: a node with more ranks than cards
    is refused before any group is joined, unless the caller names the
    device and the backend."""
    import torch.distributed as dist

    from mcan_vqa_tpu_torch.parallel import init_distributed
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k:
                        pytest.fail("joined a group"))
    with pytest.raises(RuntimeError, match="2 ranks on this node"):
        init_distributed(rank=0, world_size=2)


def test_make_mesh_shapes_match_jax():
    for shape in ({"data": 4, "model": 2}, {"data": -1, "model": 2},
                  {"data": 2}, None):
        want = dict(jmesh.make_mesh(shape).shape)
        got = make_mesh(shape, devices=["cpu"] * 8)
        assert got.shape == {"data": want["data"],
                             "model": want.get("model", 1)}
    alone = make_mesh()
    assert (alone.size, alone.distributed, alone.data_group,
            alone.model_group) == (1, False, None, None)


# ---------------------------------------------------------------------------
# the per-rank loader
# ---------------------------------------------------------------------------

class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def example(self, i):
        return {"img": np.full((3, 2), i, np.float32),
                "ques": np.array([i, i + 1], np.int32),
                "target": np.array([i % 3], np.float32),
                "qid": np.int64(1000 + i)}


@pytest.mark.parametrize("form", ["train", "eval"])
def test_loader_slices_match_jax(form):
    """Each data rank's slice, concatenated in rank order, equals JAX's
    ``BatchLoader`` at the same process_index / process_count, the padded
    last batch of the eval form included."""
    ds = _Rows(21)
    kw = (dict(shuffle=True, drop_last=True) if form == "train"
          else dict(shuffle=False, drop_last=False, pad_final=True))
    for count in (2, 4):
        jax_b = [list(JaxBatchLoader(ds, 8, seed=3, num_workers=1,
                                     process_index=i, process_count=count,
                                     **kw)) for i in range(count)]
        port_b = [list(BatchLoader(ds, 8, "cpu", seed=3, process_index=i,
                                   process_count=count, **kw))
                  for i in range(count)]
        assert len(port_b[0]) == len(jax_b[0]) == (2 if form == "train"
                                                   else 3)
        keys = ("img", "ques", "target") + (("qid", "valid")
                                            if form == "eval" else ())
        for b in range(len(jax_b[0])):
            for k in keys:
                want = np.concatenate([np.asarray(jax_b[i][b][k])
                                       for i in range(count)])
                got = np.concatenate([np.asarray(port_b[i][b][k])
                                      for i in range(count)])
                np.testing.assert_array_equal(got, want, err_msg=k)
            if form == "eval":
                assert [int(port_b[i][b]["n_valid"]) for i in range(count)] \
                    == [int(jax_b[i][b]["n_valid"]) for i in range(count)]


# ---------------------------------------------------------------------------
# the mesh Predictor
# ---------------------------------------------------------------------------

SERVE = dict(hidden_size=64, layer=1, multi_head=4, flat_mlp_size=32,
             flat_out_size=64, img_feat_size=32, img_feat_pad_size=8,
             max_token=6)
PORT_SERVE = dict(SERVE, ff_size=256)
QS = ["what color is the cat", "what is the cat"]


@pytest.fixture(scope="module")
def serving():
    """dryrun_multichip's serving setup on the port's seeded weights."""
    vocab, _ = text.build_vocab(["what color is the cat"])
    cfg = Config(**PORT_SERVE)
    sd = MCANet(cfg, len(vocab), 16,
                generator=torch.Generator().manual_seed(1)).state_dict()
    img = np.abs(np.random.default_rng(0).normal(
        size=(2, 8, 32))).astype(np.float32)
    jcfg = JConfig(use_glove=False, **SERVE).finalize()
    i2a = {str(i): f"a{i}" for i in range(16)}
    return cfg, jcfg, vocab, i2a, sd, jckpt.import_torch_state_dict(sd), img


@pytest.mark.parametrize("engine,cal,kw,tol", [
    ("plain", False, {}, 1e-5), ("fused", False, {}, 2e-2),
    ("fused", True, {}, 2e-2), ("int4", True, {}, 6e-2),
    ("fused", True, dict(q8aux=True), 6e-2)],
    ids=["plain", "fused", "calibrated", "int4", "q8aux"])
def test_mesh_predictor_matches_jax(serving, engine, cal, kw, tol):
    """``Predictor(mesh=make_mesh({"data": 2}, devices=["cpu", "cpu"]))``
    against JAX's mesh Predictor over two of its virtual devices, and
    against the port's mesh-less Predictor of the same engine."""
    cfg, jcfg, vocab, i2a, sd, params, img = serving
    extra = dict(kw, auto_calibrate=0) if cal else dict(kw)
    if cal:
        extra["act_calibration"] = (QS, img)
    jp = JaxPredictor(jcfg, params, vocab, i2a, max_batch=2, engine=engine,
                      mesh=jmesh.make_mesh({"data": 2, "model": 1},
                                           devices=jax.devices()[:2]),
                      **extra)
    mesh = make_mesh({"data": 2}, devices=["cpu", "cpu"])
    pm = Predictor(cfg, sd, vocab, i2a, max_batch=2, engine=engine,
                   mesh=mesh, **extra)
    alone = Predictor(cfg, sd, vocab, i2a, max_batch=2, engine=engine,
                      device="cpu", **extra)
    assert len(pm._live[0]["base"]) == 2
    got = pm.predict_probs(QS, img)
    np.testing.assert_allclose(got, jp.predict_probs(QS, img), atol=tol)
    np.testing.assert_allclose(got, alone.predict_probs(QS, img), atol=1e-6)


def test_mesh_predictor_calibrates_every_replica(serving):
    """The online calibration's rebuild swaps every replica at once: after
    the swap both serve level 3 with the same scales, and the mesh still
    equals the mesh-less Predictor calibrated on the same rows; a batch
    that does not split over the replicas is refused."""
    cfg, _, vocab, i2a, sd, _, img = serving
    mesh = make_mesh({"data": 2}, devices=["cpu", "cpu"])
    pm = Predictor(cfg, sd, vocab, i2a, max_batch=2, mesh=mesh,
                   auto_calibrate=2)
    pm.predict_probs(QS, img)
    assert pm.wait_calibrated(60) and pm.calibration["state"] == \
        "calibrated"
    replicas = pm._live[0]["base"]
    assert len(replicas) == 2
    assert replicas[0][0].act_scales == replicas[1][0].act_scales \
        == pm.act_scales
    alone = Predictor(cfg, sd, vocab, i2a, max_batch=2, device="cpu",
                      act_calibration=(QS, img))
    np.testing.assert_allclose(pm.predict_probs(QS, img),
                               alone.predict_probs(QS, img), atol=1e-6)
    padded_img, padded_ques = pm.pad_batch(QS, img)
    with pytest.raises(ValueError, match="do not split"):
        pm.forward_padded(padded_img[:1], padded_ques[:1])


@pytest.mark.parametrize("kw,msg", [
    (dict(mesh_shape={"data": 1, "model": 2}), "pure data-parallel"),
    (dict(mesh_shape={"data": 2}, latency_buckets=(1,)), "divide"),
    (dict(mesh_shape={"data": 2}, serving=False), "lists its devices")])
def test_mesh_predictor_refusals(serving, kw, msg):
    cfg, _, vocab, i2a, sd, _, _ = serving
    kw = dict(kw)
    shape = kw.pop("mesh_shape")
    mesh = make_mesh(shape, devices=["cpu"] * 2) if kw.pop("serving", True) \
        else make_mesh()
    with pytest.raises(ValueError, match=msg):
        Predictor(cfg, sd, vocab, i2a, max_batch=2, mesh=mesh, device="cpu",
                  **kw)


# ---------------------------------------------------------------------------
# the mesh steps against JAX (after the tests that need no rank: the
# ranks run meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dp2", "tp2", "dp2tp2"])
def test_mesh_step_matches_jax(group, name):
    """dp2, tp2 and dp2 x tp2 (grad_accu_steps 2) against JAX's
    ``jit_train_step`` on the matching mesh: the port's loss and gathered
    gradients from the ranks."""
    shape, accu, _, _ = ranks_mod.STEP_CASES[name]
    want, loss = _jax_mesh_step(shape, accu)
    got = np.load(group.results() / f"{name}.npz")
    assert abs(float(got["loss"]) - loss) / abs(loss) < 1e-4
    _compare_grads(want, _port_grads(got), 2e-4, name)


@pytest.mark.parametrize("accu", [1, 2])
def test_dp_penalty_parity(group, accu):
    """reg_factor 1e-3 at dp2 with the data group's wiring (the penalty
    divided by the data size before the loss and gradient sum): the loss
    and gradients of JAX's ``shardmap_train_step`` with ``data_axis``
    (test_parallel.py:120-150), whose penalty is divided likewise."""
    want, loss = _jax_mesh_step({"data": 2, "model": 1}, accu, reg=1e-3,
                                shardmap=True)
    # the L1 term's subgradient at a parameter that is exactly 0 (the
    # LayerNorm biases as initialised): 1 in JAX's jnp.abs, 0 in torch's
    # abs, the reference's (core/exec.py:1298-1303), which the port keeps;
    # every micro-batch's loss carries the penalty
    start = ranks_mod.step_model(ranks_mod.step_config(accu, 1e-3))
    for k, p in start.state_dict().items():
        want[k] = want[k] - accu * 1e-3 * (p.numpy() == 0)
    got = np.load(group.results() / f"dp2_reg_accu{accu}.npz")
    assert abs(float(got["loss"]) - loss) / abs(loss) < 1e-5
    _compare_grads(want, _port_grads(got), 2e-4, f"dp2 reg accu {accu}")


def test_fused_dp_step_matches_one_process(group):
    """The fused engine per data rank (reg_factor 1e-3, two micro-batches
    a rank): each rank's step is the one-process step on its rows (the
    penalty halved), so the dp2 gradient is the sum of those two steps
    bit for bit; against one step over the whole batch the loss agrees and
    the gradients within the blocks' bf16 roundings (the CPU's matmul
    takes another path at another row count, and a rounded input moves)."""
    from mcan_vqa_tpu_torch.models.layers import operand_dtype
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.step import make_train_step
    from mcan_vqa_tpu_torch.train.train_state import TrainState
    _, accu, _, reg = ranks_mod.STEP_CASES["fused_dp2_reg"]
    batch = {k: torch.from_numpy(v) for k, v in ranks_mod.step_batch().items()}
    per = ranks_mod.BATCH // 2

    def one_process(rows, reg_factor):
        cfg = ranks_mod.step_config(accu, reg_factor)
        model = ranks_mod.step_model(cfg)
        state = TrainState.create(model, torch.optim.SGD(
            model.parameters(), lr=1.0))
        step = make_train_step(make_fused_train_forward(
            cfg.layer, cfg.multi_head, dropout_rate=0.0, sga_block="fused",
            fused_encoder=True), grad_accu_steps=accu,
            reg_factor=reg_factor)
        with operand_dtype(torch.float32):
            loss = float(step(state, {k: v[rows] for k, v in
                                      batch.items()})["loss"])
        return loss, {n: p.grad.numpy() for n, p in model.named_parameters()}

    # a rank's penalty is halved: half of it on each rank's rows
    halves = [one_process(slice(r * per, (r + 1) * per), reg / 2)
              for r in range(2)]
    loss, whole = one_process(slice(None), reg)
    got = np.load(group.results() / "fused_dp2_reg.npz")
    summed = {k: halves[0][1][k] + halves[1][1][k] for k in whole}
    _compare_grads(summed, _port_grads(got), 1e-6, "fused dp2 vs halves")
    assert abs(float(got["loss"]) - loss) / loss < 1e-6
    _compare_grads(whole, _port_grads(got), 5e-3, "fused dp2 vs one step")


# ---------------------------------------------------------------------------
# the Trainer on the mesh, and the fused engines per data rank
# ---------------------------------------------------------------------------

def test_trainer_dp2_tp2_end_to_end(group):
    """A dp2 x tp2 Trainer trains 2 epochs (8 steps) on the plain engine
    (the fused engines refuse a model axis), writes the pickle a
    one-process run writes (loaded by JAX's ``import_torch_checkpoint``),
    resumes for a third epoch, and every rank's ``predict`` is the whole
    result."""
    out = group.results()
    res = np.load(out / "trainer.npz")
    assert int(res["steps"]) == 8 and int(res["resumed_steps"]) == 12
    assert not res["fused"] and not res["fused_eval"]
    assert np.isfinite(float(res["roc_micro"]))
    preds = [np.load(out / f"trainer_predict_{r}.npz") for r in range(WORLD)]
    assert preds[0]["probs"].shape == (64, 8)
    np.testing.assert_array_equal(preds[0]["qids"], np.arange(64))
    for p in preds[1:]:
        np.testing.assert_array_equal(p["probs"], preds[0]["probs"])
    ckpt = out / "ckpts" / "ckpt_mesh"
    assert sorted(os.listdir(ckpt)) == ["epoch1.pkl", "epoch2.pkl",
                                        "epoch3.pkl"]
    blob = torch.load(ckpt / "epoch3.pkl", weights_only=True)
    cfg = Config(**ranks_mod.TRAINER)
    one = MCANet(cfg, 40, 8).state_dict()
    assert list(blob["state_dict"]) == reference_param_keys(cfg.layer)
    assert {k: tuple(v.shape) for k, v in blob["state_dict"].items()} == \
        {k: tuple(v.shape) for k, v in one.items()}
    moments = blob["optimizer"]["state"]
    for i, k in enumerate(reference_param_keys(cfg.layer)):
        assert tuple(moments[i]["exp_avg"].shape) == tuple(one[k].shape)
    assert float(moments[0]["step"]) == 12
    params, meta = jckpt.import_torch_checkpoint(str(ckpt / "epoch3.pkl"))
    assert "optimizer" in meta
    k = params["backbone"]["enc_0"]["mhatt"]["linear_q"]["kernel"]
    assert k.shape == (32, 32)


def test_sigterm_on_one_rank_stops_every_rank(group):
    """SIGTERM on rank 3 inside step 2 of a dp2 x tp2 epoch: every rank
    stops after step 2, rank 0 checkpoints and logs preempted_at_step
    (the signal line is rank 3's, whose log is off)."""
    out = group.results()
    steps = [json.loads((out / f"preempt_{r}.json").read_text())["step"]
             for r in range(WORLD)]
    assert steps == [2] * WORLD
    log = (out / "preempt" / "log" / "log_run_stop.txt").read_text()
    assert "preempted_at_step=2" in log
    assert os.listdir(out / "preempt" / "ckpts" / "ckpt_stop") == \
        ["epoch1.pkl"]


@pytest.mark.parametrize("task", ["classify", "mimic"])
def test_fused_engines_per_data_rank(group, task):
    """dryrun_multichip's fused dp runs: the classifier (fused SA blocks)
    and MIMIC-flavoured VQA (multi-hot targets, L1 + L2 penalty) train a
    step per data rank through the fused engines and evaluate."""
    res = np.load(group.results() / f"{task}.npz")
    assert int(res["steps"]) == 1 and res["fused"] and res["fused_eval"]
    assert res["probs"].shape == (4, 14)
    assert np.isfinite(res["probs"]).all()
    assert np.isfinite(float(res["roc_micro"]))
