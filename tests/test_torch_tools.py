"""The port's tools on the CPU: ``cli/build_answer_dict.py`` against the JAX
CLI, ``cli/param_footprint.py``, ``cli/bench_host_feed.py``, the
interleaved-rounds timer (``cli/ab_timer.py``) on a fake clock,
``cli/train_roofline.py``'s counts, ``utils/compile_cache.py`` and the
CLIs' ``--compile_cache``, and the card-only tools' refusal without a CUDA
device."""

import json

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.cli import build_answer_dict as jbuild
from mcan_vqa_tpu_torch.cli import (ab_timer, bench_classifier_serve,
                                    bench_host_feed, bench_serving_ab,
                                    bench_train_ab, build_answer_dict,
                                    param_footprint, run_classify,
                                    run_mimic, run_vqa, serve,
                                    train_roofline, validate_inkernel_dw,
                                    validate_prng_dropout)
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.utils import compile_cache


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (ROADMAP, "Thread oversubscription")."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_build_answer_dict_writes_the_jax_cli_json(tmp_path):
    paths = write_vqa_files(str(tmp_path / "files"), feat_dim=4,
                            regions=(1, 2))
    ours, theirs = tmp_path / "ours.json", tmp_path / "jax.json"
    for main, out in ((build_answer_dict.main, ours), (jbuild.main, theirs)):
        assert main(["--dataset_path", paths["dataset_path"],
                     "--min_freq", "0", "--out", str(out)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    ans_to_ix, ix_to_ans = json.loads(ours.read_text())
    assert len(ans_to_ix) == len(ix_to_ans) > 1


TINY = dict(hidden_size=32, ff_size=128, layer=1, multi_head=4,
            img_feat_size=16, img_feat_pad_size=8, max_token=6,
            flat_out_size=32, flat_mlp_size=16)


def test_param_footprint_plain_is_the_state_dict():
    cfg = Config(**TINY)
    got = param_footprint.footprint(cfg, torch.device("cpu"), token_size=40,
                                    answer_size=12,
                                    engines=("plain", "bf16", "level3",
                                             "int8"))
    sd = MCANet(cfg, 40, 12).state_dict()
    assert got["plain"] == sum(v.numel() * v.element_size()
                               for v in sd.values())
    # the bf16 tree holds every matrix in half the bytes, the biases and
    # norms in f32: less than the f32 state_dict
    assert 0 < got["bf16"] < got["plain"]
    assert got["level3"] > 0 and got["int8"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device "
                    "is present: the footprint would be taken there")
def test_param_footprint_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        param_footprint.main(["--models", "small"])


def test_tree_bytes_counts_a_shared_storage_once():
    base = torch.zeros(10, 4)
    tree = {"a": base, "b": [base[0], base.t()], "c": (torch.ones(3),)}
    assert param_footprint.tree_bytes(tree) == 160 + 12


def test_bench_host_feed_on_the_cpu(tmp_path, capsys):
    ab = tmp_path / "ab.json"
    ab.write_text(json.dumps({"bench": "serving_ab", "configs": {
        "qffn": {"ms": 1.0, "per_s": 64000.0},
        "bf16": {"ms": 2.0, "per_s": 32000.0}}}) + "\n")
    rec = bench_host_feed.main(["--items", "64", "--batch", "8",
                                "--iters", "2", "--threads", "1", "2",
                                "--target-from", str(ab)])
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert set(rec["threads"]) == {"1", "2"} and rec["best_samples_per_s"] > 0
    assert rec["target_samples_per_s"] == 64000.0
    assert rec["threads_for_target"] == pytest.approx(
        64000.0 / rec["per_thread"])
    with pytest.raises(SystemExit):
        bench_host_feed.main(["--items", "64"])    # no target


def test_interleaved_rounds_on_a_fake_clock():
    order = []
    clock = {"a": iter([3.0, 1.0, 2.0, 5.0]), "b": iter([4.0] * 4)}

    def timer(fn):
        name = fn()
        order.append(name)
        return next(clock[name])

    got = ab_timer.interleaved({"a": lambda: "a", "b": lambda: "b"},
                               rounds=4, timer=timer)
    assert order == ["a", "b"] * 4
    assert got["a"]["rounds"] == [3.0, 1.0, 2.0, 5.0]
    assert got["a"]["ms"] == 2.5 and got["a"]["min_ms"] == 1.0 \
        and got["a"]["max_ms"] == 5.0
    assert got["a"]["spread_pct"] == pytest.approx((5.0 - 1.0) / 2.5 * 100)
    assert got["b"]["ms"] == 4.0 and got["b"]["spread_pct"] == 0.0


def test_interleaved_default_timer_is_one_median_ms_round(monkeypatch):
    """Each turn is bench_stacks.median_ms over one round of ``calls``."""
    from mcan_vqa_tpu_torch.cli import bench_stacks
    seen = []

    def fake_median_ms(torch_mod, fn, rounds, calls):
        seen.append((fn(), rounds, calls))
        return float(len(seen))

    monkeypatch.setattr(bench_stacks, "median_ms", fake_median_ms)
    got = ab_timer.interleaved({"a": lambda: "a", "b": lambda: "b"},
                               rounds=2, calls=7)
    assert seen == [("a", 1, 7), ("b", 1, 7), ("a", 1, 7), ("b", 1, 7)]
    assert got["a"]["rounds"] == [1.0, 3.0] and got["b"]["ms"] == 3.0


def test_report_line(capsys, monkeypatch):
    monkeypatch.setattr(ab_timer, "card", lambda: "card, 700.00 W")
    rec = ab_timer.report("t", {"a": {"ms": 2.0}}, per_call=64, B=64)
    line = json.loads(capsys.readouterr().out)
    assert line == rec and line["configs"]["a"]["per_s"] == 32000.0
    assert line["card"] == "card, 700.00 W" and line["B"] == 64


@pytest.mark.parametrize("model,itemised", [("small", 3.54),
                                            ("large", 13.8)])
def test_train_roofline_forward_count(model, itemised):
    """Within 2% of docs/PERFORMANCE.md's itemised per-sample count."""
    cfg = Config.for_model(model)
    got = train_roofline.forward_flops(cfg)["total"] / 1e9
    assert abs(got / itemised - 1.0) <= 0.02
    rec = train_roofline.roofline(cfg, 64)
    assert rec["step_gflop"] == pytest.approx(3 * got * 64)
    assert rec["bound_ms"] == max(rec["flop_ms"], rec["byte_ms"])


def test_train_roofline_counts_the_parameters():
    cfg = Config(**TINY)
    assert train_roofline.param_count(cfg, 40, 12) == sum(
        p.numel() for p in MCANet(cfg, 40, 12).parameters())


def test_train_roofline_reads_the_ab_line(tmp_path, capsys):
    ab = tmp_path / "ab.json"
    ab.write_text(json.dumps({"bench": "train_ab", "model": "small",
                              "B": 64, "card": "c", "configs": {
                                  "standard": {"ms": 70.0},
                                  "stacked": {"ms": 60.0}}}) + "\n")
    rec = train_roofline.main(["--models", "small", "--ab", str(ab)])[0]
    m = rec["measured"]["stacked"]
    assert m["share_of_bound"] == pytest.approx(rec["bound_ms"] / 60.0)
    assert set(rec["measured"]) == {"standard", "stacked"}
    capsys.readouterr()


def test_compile_cache_resolves_and_returns_none(tmp_path, monkeypatch):
    monkeypatch.delenv("MCAN_COMPILE_CACHE", raising=False)
    assert compile_cache.resolve(str(tmp_path / "c")) == str(tmp_path / "c")
    assert compile_cache.resolve("OFF") is None
    assert compile_cache.resolve() == compile_cache.default_cache_dir()
    monkeypatch.setenv("MCAN_COMPILE_CACHE", "disabled")
    assert compile_cache.resolve() is None
    monkeypatch.setenv("MCAN_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.resolve() == str(tmp_path / "env")
    assert compile_cache.enable(str(tmp_path / "d")) is None
    assert compile_cache.enable() is None
    assert not (tmp_path / "d").exists() and not (tmp_path / "env").exists()


@pytest.mark.parametrize("parse,base", [
    (run_vqa.parse_args, ["--run", "train"]),
    (run_classify.parse_args, ["--run", "train"]),
    (run_mimic.parse_args, ["--run", "train"]),
    (serve.parse_args, [])], ids=["run_vqa", "run_classify", "run_mimic",
                                  "serve"])
def test_clis_accept_compile_cache(parse, base):
    assert parse(base + ["--compile_cache", "off"]).compile_cache == "off"
    assert parse(base).compile_cache is None


def test_serving_ab_configs():
    assert bench_serving_ab.engine_kwargs("qffn") == dict(qffn=1)
    assert bench_serving_ab.engine_kwargs("qstatic") == dict(
        qffn=None, q8aux=False, calibrated=True)
    assert bench_serving_ab.engine_kwargs("qaux5") == dict(
        qffn=5, q8aux=True, calibrated=True)
    with pytest.raises(SystemExit):
        bench_serving_ab.engine_kwargs("qffn@g8")
    assert bench_classifier_serve.level_of("qffn2") == (2, False)
    assert bench_classifier_serve.level_of("qstatic") == (None, True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device "
                    "is present: the card-only tools would run")
@pytest.mark.parametrize("main", [
    bench_serving_ab.main, bench_classifier_serve.main, bench_train_ab.main,
    validate_prng_dropout.main, validate_inkernel_dw.main],
    ids=["bench_serving_ab", "bench_classifier_serve", "bench_train_ab",
         "validate_prng_dropout", "validate_inkernel_dw"])
def test_card_tools_refuse_without_a_card(main, capsys):
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in (str(e.value.code) + capsys.readouterr().err)


def test_host_feed_cache_is_packed_cache(tmp_path):
    rng = np.random.default_rng(0)
    cache, rows = bench_host_feed.write_cache(str(tmp_path), 5, 8, 12, rng)
    assert rows == sum(n for _, n in cache.index.values())
    assert cache.get_padded("4", 12).shape == (12, 8)
