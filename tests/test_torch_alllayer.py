"""The JAX serving engine's other decoder modes in the port, on the CPU
(the plain versions of the kernels), against the JAX package:

  * the four TPU kernels of those modes in interpret mode --
    ``fused_sga_block(fused_proj=False)`` (mode 1, head-major weights),
    ``fused_sga_decoder`` (mode 3), ``fused_sga_decoder_extkv`` (modes 4
    and 5) and ``fused_sa_encoder`` (mode 5) -- at packing groups 1 and 2,
    on partly padded samples, and the fully padded sample: JAX packs G
    samples under one collapsed mask, so at G = 2 that sample attends to
    its neighbour's keys and the port (per sample, model.apply) differs,
    at G = 1 both agree;
  * ``build_production_engine(sga_mode=1|3|4|5)`` against JAX's,
    both ``alllayer`` settings, ``qffn=0`` and the default level, mode 1
    with ``q8aux`` and stored scales; ``sga_group`` on both;
  * the gates: ``decoder_vmem_ok`` / ``encoder_vmem_ok`` against JAX's,
    the all-layer stacks attached where JAX attaches them and equal to
    JAX's, and the modes that a width past ``decoder_vmem_ok`` degrades to
    mode 2, bit for bit.

JAX weights come from ``import_torch_state_dict`` of a seeded port
``MCANet`` (no model.init compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu.ops import sga_block as jblock
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.ops import sga_block as tblock

DIMS = dict(hidden_size=32, layer=2, multi_head=4, img_feat_size=16,
            img_feat_pad_size=8, max_token=7, flat_out_size=24,
            flat_mlp_size=16)
L, H, D, LV, LQ = 2, 4, 32, 8, 7
TOKENS, ANSWERS = 30, 12
# the same steps at the same precision on both sides, summed in another
# order by XLA and by torch: a bf16 rounding (of q, k, v, h1, the
# probabilities, |x| < 4) can land one step apart, 2^-7 relative; through
# a 2-layer stack that reaches a few 2^-7 on the LayerNorm scale
TOL = 2 ** -5
# the fully padded sample at G = 2: JAX mixes in the neighbour's keys
DIFFERS = 0.1


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port state_dict, JAX prepared tree, port prepared
    tree), the trees with every layout (alllayer, unpruned)."""
    cfg = Config(ff_size=4 * D, **DIMS)
    sd = MCANet(cfg, TOKENS, ANSWERS, generator=torch.Generator()
                .manual_seed(0)).state_dict()
    params = jax.device_get(import_torch_state_dict(sd))
    jprep = jserving.prepare_params(params, L, num_heads=H, alllayer=True)
    tprep = tserving.prepare_params(sd, L, device="cpu", prune=False,
                                    num_heads=H, alllayer=True)
    return params, sd, jprep["backbone"], tprep["backbone"]


def _inputs(B=4, seed=1):
    """Streams, pre-projected cross k/v (every layer) and masks; samples 0-2
    partly padded, sample 3 fully padded (an all-zero image, an all-PAD
    question)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, LV, D)).astype(np.float32)
    q = rng.normal(size=(B, LQ, D)).astype(np.float32)
    kv = rng.normal(size=(2, B, L * H, LQ, D // H)).astype(np.float32)
    v_mask = (np.arange(LV)[None, :] >= np.array([8, 5, 3, 0])[:, None])
    q_mask = (np.arange(LQ)[None, :] >= np.array([7, 2, 4, 0])[:, None])
    return v, q, kv, v_mask[:, None, None, :], q_mask[:, None, None, :]


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _run(kernel, group, jbb, tbb):
    """(JAX out, port out) as f32 numpy for one kernel at one group."""
    v, q, kv, vm, qm = _inputs()
    (vj, vt), (qj, qt) = _bf16(v), _bf16(q)
    vmj, qmj = jnp.asarray(vm), jnp.asarray(qm)
    vmt, qmt = torch.from_numpy(vm), torch.from_numpy(qm)
    if kernel == "sga_block":
        kq, vq = kv[0][:, :H], kv[1][:, :H]
        ref = jblock.fused_sga_block(vj, kq, vq, vmj, qmj, jbb["dec_0"]["_mk"],
                                     num_heads=H, group=group,
                                     fused_proj=False, interpret=True)
        out = tblock.fused_sga_block(vt, torch.from_numpy(kq),
                                     torch.from_numpy(vq), vmt, qmt,
                                     tbb["dec_0"]["_mk"], num_heads=H,
                                     group=group, fused_proj=False)
    elif kernel == "sga_decoder":
        ref = jblock.fused_sga_decoder(vj, qj, vmj, qmj, jbb["_mk_dec"],
                                       num_heads=H, group=group,
                                       interpret=True)
        out = tblock.fused_sga_decoder(vt, qt, vmt, qmt, tbb["_mk_dec"],
                                       num_heads=H, group=group)
    elif kernel == "sga_decoder_extkv":
        ref = jblock.fused_sga_decoder_extkv(vj, kv[0], kv[1], vmj, qmj,
                                             jbb["_mk_dec"], num_heads=H,
                                             group=group, interpret=True)
        out = tblock.fused_sga_decoder_extkv(
            vt, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]), vmt, qmt,
            tbb["_mk_dec"], num_heads=H, group=group)
    else:
        ref = jblock.fused_sa_encoder(qj, qmj, jbb["_mk_enc"], num_heads=H,
                                      group=group, interpret=True)
        out = tblock.fused_sa_encoder(qt, qmt, tbb["_mk_enc"], num_heads=H,
                                      group=group)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    return np.asarray(jnp.asarray(ref, jnp.float32)), out.float().numpy()


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("kernel", ["sga_block", "sga_decoder",
                                    "sga_decoder_extkv", "sa_encoder"])
def test_kernel_matches_pallas_and_pins_the_padded_sample(weights, kernel,
                                                          group):
    """The partly padded samples agree at either group; the fully padded
    one (sample 3) agrees at G = 1 and differs at G = 2, where JAX's
    collapsed mask lets it attend to sample 2's keys."""
    _, _, jbb, tbb = weights
    ref, out = _run(kernel, group, jbb, tbb)
    np.testing.assert_allclose(out[:3], ref[:3], rtol=TOL, atol=TOL)
    pad_gap = np.abs(out[3] - ref[3]).max()
    if group == 1:
        assert pad_gap <= TOL
    else:
        assert pad_gap > DIFFERS


def test_head_major_layout_is_jax_s(weights):
    """The decoder block's head-major entries equal JAX's (views of the
    fused ones in the port), and the mode-2 prune drops them on both
    sides."""
    params, sd, jbb, tbb = weights
    jmk, tmk = jbb["dec_1"]["_mk"], tbb["dec_1"]["_mk"]
    for k in tblock.HEAD_MAJOR:
        np.testing.assert_array_equal(
            tmk[k].float().numpy(), np.asarray(jnp.asarray(jmk[k], jnp.float32)))
    assert tmk["wq1"].untyped_storage().data_ptr() == \
        tmk["wqkv1"].untyped_storage().data_ptr()
    jp = jserving.prune_prepared_params(
        jserving.prepare_params(params, L, num_heads=H, alllayer=True), L)
    tp = tserving.prune_prepared_params(
        {"backbone": tbb}, L)
    assert set(tp["backbone"]["dec_0"]["_mk"]) == \
        set(jp["backbone"]["dec_0"]["_mk"])
    assert set(tp["backbone"]) == set(jp["backbone"])


def test_stacks_are_jax_s_and_attached_where_jax_attaches(weights,
                                                         monkeypatch):
    params, sd, jbb, tbb = weights
    for stack in ("_mk_dec", "_mk_enc"):
        assert set(tbb[stack]) == set(jbb[stack])
        for k, t in tbb[stack].items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(jnp.asarray(jbb[stack][k], jnp.float32)))

    def attached(alllayer):
        j = jserving.prepare_params(params, L, num_heads=H,
                                    alllayer=alllayer)["backbone"]
        t = tserving.prepare_params(sd, L, device="cpu", prune=False,
                                    num_heads=H,
                                    alllayer=alllayer)["backbone"]
        return ("_mk_dec" in j, "_mk_enc" in j), ("_mk_dec" in t,
                                                   "_mk_enc" in t)

    j, t = attached(False)
    assert j == t == (False, False)
    monkeypatch.setattr(jblock, "decoder_vmem_ok", lambda D, F, L: False)
    monkeypatch.setattr(tserving, "decoder_vmem_ok", lambda D, F, L: False)
    j, t = attached(True)
    assert j == t == (False, False)


@pytest.mark.parametrize("D_", [64, 256, 512, 640, 1024])
def test_all_layer_gates_match_jax(D_):
    for F in (2 * D_, 4 * D_, 4096):
        for n in (1, 2, 6, 12):
            assert tblock.decoder_vmem_ok(D_, F, n) == \
                jblock.decoder_vmem_ok(D_, F, n)
            assert tblock.encoder_vmem_ok(D_, F, n) == \
                jblock.encoder_vmem_ok(D_, F, n)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

B = 6


@pytest.fixture(scope="module")
def batch():
    """Partly padded samples only: JAX packs the decoder's samples in
    groups of 3 here (auto 4, cut to divide 6) and the encoder's in one
    group of 6, so a fully padded sample would take its neighbours' keys
    (the kernel tests above pin that)."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, LV, DIMS["img_feat_size"])).astype(np.float32)
    img[0, 5:] = 0.0
    img[3, 2:] = 0.0
    ques = rng.integers(1, TOKENS, size=(B, LQ)).astype(np.int32)
    ques[1, 4:] = 0
    ques[4, 1:] = 0
    return img, ques


def _forward(fwd, prep, img, ques):
    with torch.no_grad():
        return fwd(prep, torch.from_numpy(img), torch.from_numpy(ques))


_JAX_LOGITS = {}


def _engines(weights, batch, **kw):
    """(JAX logits, port logits, port tree) of one engine setting. JAX's
    logits do not depend on ``alllayer`` (the stacks or the same stacks
    per call), so each is computed once per other setting."""
    params, sd, _, _ = weights
    img, ques = batch
    key = repr(sorted((k, v) for k, v in kw.items() if k != "alllayer"))
    if key not in _JAX_LOGITS:
        jfwd, jprep = jserving.build_production_engine(params, L, H,
                                                       interpret=True, **kw)
        _JAX_LOGITS[key] = np.asarray(jfwd(jprep, img, ques))
    fwd, prep = tserving.build_production_engine(sd, L, H, device="cpu", **kw)
    return _JAX_LOGITS[key], _forward(fwd, prep, img, ques).numpy(), prep


# logits: a bf16 rounding a step apart carries through 4 blocks, 1e-2 on
# |logit| ~ 1, as for the mode-0 and mode-2 engines
ENGINE_TOL = 1e-2


@pytest.mark.parametrize("mode,kw", [
    (1, dict(qffn=0)), (1, dict(qffn=0, alllayer=True)),
    (3, dict(qffn=0)), (3, dict(qffn=0, alllayer=True)),
    (4, dict(qffn=0)), (4, dict(qffn=0, alllayer=True)),
    (5, dict(qffn=0)), (5, dict(qffn=0, alllayer=True)),
    (3, dict()), (4, dict(alllayer=True)),
    (1, dict(q8aux=True, act_scales="stored"))],
    ids=["1", "1-alllayer", "3", "3-alllayer", "4", "4-alllayer", "5",
         "5-alllayer", "3-level1", "4-level1-alllayer", "1-q8aux"])
def test_engine_matches_jax(weights, batch, mode, kw):
    if kw.get("act_scales") == "stored":
        # scales calibrated once by the port, the same floats to both
        fwd, _ = tserving.build_production_engine(
            weights[1], L, H, device="cpu", q8aux=True,
            act_scale_inputs=tuple(map(torch.from_numpy, batch)))
        kw = dict(kw, act_scales=fwd.act_scales)
    ref, out, prep = _engines(weights, batch, sga_mode=mode, **kw)
    assert out.shape == (B, ANSWERS) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=ENGINE_TOL, atol=ENGINE_TOL)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    bb = prep["backbone"]
    assert ("_mk_dec" in bb) == ("_mk_enc" in bb) == \
        kw.get("alllayer", False)


def test_sga_group_is_accepted_on_both_sides(weights, batch):
    """JAX's build_production_engine and make_serving_fn take sga_group (the
    packing group); the port's accept it without effect. On partly padded
    samples both agree."""
    ref, out, _ = _engines(weights, batch, qffn=0, sga_group=2)
    np.testing.assert_allclose(out, ref, rtol=ENGINE_TOL, atol=ENGINE_TOL)
    fwd, prep = tserving.build_production_engine(weights[1], L, H, qffn=0,
                                                 device="cpu")
    assert torch.equal(torch.from_numpy(out),
                       _forward(fwd, prep, *batch))


@pytest.mark.parametrize("mode", [3, 4, 5])
def test_alllayer_modes_past_the_gate_serve_mode2(weights, batch, mode,
                                                  monkeypatch):
    """A width that fails decoder_vmem_ok (here: a gate that fails every
    width) but passes megakernel_vmem_ok: modes 3-5 serve mode 2, bit for
    bit, and attach no stack (serving.py:837-840)."""
    sd = weights[1]
    monkeypatch.setattr(tserving, "decoder_vmem_ok", lambda D, F, L: False)
    mode2, prep2 = tserving.build_production_engine(sd, L, H, qffn=0,
                                                    device="cpu")
    fwd, prep = tserving.build_production_engine(sd, L, H, qffn=0,
                                                 sga_mode=mode,
                                                 alllayer=True, device="cpu")
    assert "_mk_dec" not in prep["backbone"]
    assert torch.equal(_forward(fwd, prep, *batch),
                       _forward(mode2, prep2, *batch))
