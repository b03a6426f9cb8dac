"""Device time of the Hopper GEMMs at the main paths' shapes.

    python mcan_vqa_tpu_torch/cli/bench_gemm.py [--root DIR] [--tag T]
        [--forward] [--units X,XB1,...]

Times ``gemm_bias_act`` (the forward product a . w + bias with its ReLU /
keep-mask / Philox epilogue), ``gemm_dx`` (dY . W^T with its gate /
residual epilogue), ``gemm_dw`` (X^T . dY, f32), ``gemm_s8`` (the int8
product with its dequantizing epilogue) and the int4 products ``gemm_s4``
/ ``gemm_w4bf16`` of the ``mcan_vqa_tpu_torch``
package under ``--root`` (default: the checkout this file lies in; another
checkout, such as an older commit unpacked with ``git archive``, compares
two versions within one run on the card) beside one PyTorch call of the
same operands (``torch.addmm`` with a bf16 bias for the forward,
``torch.mm`` for the backward, ``torch._int_mm`` for the int8 product,
whose int32 output is its own), at every shape of

  * unit S: one B=64 bf16 serving forward of MCAN-small (the six SA
    encoder blocks at M = 896 rows, the six SGA decoder blocks at 3840);
  * unit B1: the same forward at B=1 (M = 14 and 60), each shape also
    timed eagerly (CUDA events around eager calls: the host's issue time,
    tensor-map encodes included, counts);
  * unit T, one B=64 MCAN-small train step: the six SGA decoder blocks (M
    = R = 3840 rows, D 512, F 2048; the forward products and the attention
    backward's recomputed projections) and the six SA encoder blocks (896
    rows), the FFN's first product with the h1 dropout drawn in the
    kernel (Philox), as the Trainer runs it on the card;
  * unit L, one B=64 MCAN-large train step: the six SGA decoder blocks of
    each of the two micro-batches of 32 (1920 rows, D 1024, F 4096, bf16
    saves);
  * unit Q, the default serving engine: one B=64 MCAN-small forward at int8
    level 1 (the FFN, per-row scales) and one at level 3 (every
    projection, static scales), each weight prepared as that checkout's
    ``_quant_w`` prepares it;
  * units W5 / W7, the int4 engine: one B=1 and one B=64 MCAN-small forward
    at level 5 (``gemm_s4`` at every qkv, w1 and w2) / level 7
    (``gemm_w4bf16`` at the same sites), each weight prepared as that
    checkout's ``_quant_w4`` prepares it; beside each site ``gemm_s8`` on
    the site's int8 weight and ``gemm_bias_act`` on its dequantized bf16
    weight (the port's own kernels; no single PyTorch call computes a
    grouped int4 product, so mm_ms is null).

  * units M0 / M0B1 / H1536 / H2048, the per-sub-op serving path
    (sga_mode=0): ``gemm_ln`` at every site of one forward (per layer the
    encoder's merge and FFN, the decoder's two merges and FFN; the merges
    read the f32 attention output, the FFNs the bf16 hidden, a bf16
    stream) -- MCAN-small at B=64 (M0: decoder 3840 rows, encoder 896) and
    B=1 (M0B1: 60, 14), the default Predictor at hidden 1536 / 2048 and
    B=8 (480, 112 rows; F = 4 D) -- and ``attflat_pool`` at both AttFlats
    of M0 and M0B1 (the kernel AttFlat, use_pallas_attflat); beside each
    gemm_ln site two yardsticks, the port's unfused pair on the same
    operands (``gemm_bias_act`` for the product, then
    ``residual_layernorm``; the f32 a cast to bf16 beforehand, outside the
    time) and ``torch.addmm`` for the product alone.

  * units X / XB1 / XS, the streaming FFN + LayerNorm kernels
    (``ffn_ln_blocked``, ``ffn_ln_wstationary``; no engine calls them): one
    call at MCAN-large B=64 (M 3840, D 1024, F 4096), MCAN-large B=1 (M
    60) and MCAN-small B=64 (M 3840, D 512, F 2048), f32 x; beside each
    the plain version (``ffn_ln_plain``), the port's own unfused pair on
    the same operands (``gemm_bias_act`` for h = relu(x . W1 + b1) in bf16,
    then ``gemm_ln``: the same function with h through HBM; x cast to bf16
    for the first product outside the time) and ``torch.addmm`` of each
    product (a bf16 bias). Both kernels are timed in a CUDA graph like the
    rest (a cluster launch is captured), and also eagerly (``eager_ms``:
    CUDA events around 50 eager calls, host issue included); an older
    checkout's cooperative weight-stationary launch only eagerly, and its
    line says ``"timing": "eager"``.

``--units`` limits the run to the units named (comma-separated).

A forward shape's h1 keep-mask read from memory is timed once more with
0 calls per unit. Each device time: 50 calls captured in one CUDA graph,
replayed 5 times, the median per call. Prints one JSON line per shape, one
per kernel and unit with the unit's totals (calls x time; the bound at 989
TFLOP/s bf16 and 3.35 TB/s, each input read once and each output written
once; int8 operations at 1,979 TOP/s), then the card. ``--forward`` also
times one MCAN-small ``Predictor`` forward at B = 1, 8 and 64 (seeded
random weights; the default engine at int8 level 1, at level 3 calibrated
on one batch, the int4 engine at level 5 and level 7, calibrated on the
same batch, and the bf16 one, ``qffn=0``; median of 5 rounds of 10 eager
calls), then the per-sub-op forward at B = 1, 8 and 64: MCAN-small's
bf16 mode-0 engine (``build_production_engine(qffn=0, sga_mode=0)``) and
the default Predictor at hidden 1536 (which serves mode 0), each eager
and, where the capture takes it, as one CUDA graph of its engine (device
time), with the host-bound share 1 - graph / eager beside it. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_BF16, PEAK_INT8, HBM = 989e12, 1979e12, 3.35e12

# (unit, label, M, K, N, relu, out size, keep-mask: None, "mask" or
# "seeded", calls per unit)
NN = [("S", "enc qkv", 896, 512, 1536, False, 2, None, 6),
      ("S", "enc merge", 896, 512, 512, False, 4, None, 6),
      ("S", "enc ffn1", 896, 512, 2048, True, 2, None, 6),
      ("S", "enc ffn2", 896, 2048, 512, False, 4, None, 6),
      ("S", "dec qkv", 3840, 512, 1536, False, 2, None, 6),
      ("S", "dec merge", 3840, 512, 512, False, 4, None, 12),
      ("S", "dec ffn1", 3840, 512, 2048, True, 2, None, 6),
      ("S", "dec ffn2", 3840, 2048, 512, False, 4, None, 6),
      ("S", "dec q2", 3840, 512, 512, False, 2, None, 6),
      ("B1", "enc qkv", 14, 512, 1536, False, 2, None, 6),
      ("B1", "enc merge", 14, 512, 512, False, 4, None, 6),
      ("B1", "enc ffn1", 14, 512, 2048, True, 2, None, 6),
      ("B1", "enc ffn2", 14, 2048, 512, False, 4, None, 6),
      ("B1", "dec qkv", 60, 512, 1536, False, 2, None, 6),
      ("B1", "dec merge", 60, 512, 512, False, 4, None, 12),
      ("B1", "dec ffn1", 60, 512, 2048, True, 2, None, 6),
      ("B1", "dec ffn2", 60, 2048, 512, False, 4, None, 6),
      ("B1", "dec q2", 60, 512, 512, False, 2, None, 6),
      ("T", "ffn1 + h1 seeded", 3840, 512, 2048, True, 2, "seeded", 6),
      ("T", "ffn1 + h1 mask", 3840, 512, 2048, True, 2, "mask", 0),
      ("T", "qkv", 3840, 512, 1536, False, 2, None, 12),
      ("T", "merge, merge2", 3840, 512, 512, False, 4, None, 24),
      ("T", "q2", 3840, 512, 512, False, 2, None, 12),
      ("T", "ffn2", 3840, 2048, 512, False, 4, None, 6),
      ("T", "enc qkv", 896, 512, 1536, False, 2, None, 12),
      ("T", "enc merge", 896, 512, 512, False, 4, None, 12),
      ("T", "enc ffn1 + h1 seeded", 896, 512, 2048, True, 2, "seeded", 6),
      ("T", "enc ffn2", 896, 2048, 512, False, 4, None, 6),
      ("L", "qkv", 1920, 1024, 3072, False, 2, None, 12),
      ("L", "merge, merge2", 1920, 1024, 1024, False, 4, None, 24),
      ("L", "q2", 1920, 1024, 1024, False, 2, None, 12),
      ("L", "ffn1 + h1 seeded", 1920, 1024, 4096, True, 2, "seeded", 12),
      ("L", "ffn1 + h1 mask", 1920, 1024, 4096, True, 2, "mask", 0),
      ("L", "ffn2", 1920, 4096, 1024, False, 4, None, 12)]
# (unit, label, rows, K = width of dy, N = width of dx, gate, res, out
# sizes, calls per unit)
DX = [("T", "da1 = dy3 W2^T, gate", 3840, 512, 2048, True, False, (4, 2), 6),
      ("T", "gv2 = da1 W1^T + gr3", 3840, 2048, 512, False, True, (4,), 6),
      ("T", "datt2 = dy2 Wm2^T", 3840, 512, 512, False, False, (2,), 6),
      ("T", "gv1 = dqx Wq2^T + gr2", 3840, 512, 512, False, True, (4,), 6),
      ("T", "datt1 = dy1 Wm1^T", 3840, 512, 512, False, False, (2,), 6),
      ("T", "dx = dqkv Wqkv^T + gr1", 3840, 1536, 512, False, True, (4,), 6),
      ("T", "enc da1, gate", 896, 512, 2048, True, False, (4, 2), 6),
      ("T", "enc gx1 + gr2", 896, 2048, 512, False, True, (4,), 6),
      ("T", "enc datt", 896, 512, 512, False, False, (2,), 6),
      ("T", "enc dx + gr1", 896, 1536, 512, False, True, (4,), 6),
      ("L", "da1, gate", 1920, 1024, 4096, True, False, (4, 2), 12),
      ("L", "gv2 + gr3 -> bf16", 1920, 4096, 1024, False, True, (2,), 12),
      ("L", "datt2", 1920, 1024, 1024, False, False, (2,), 12),
      ("L", "gv1 + gr2", 1920, 1024, 1024, False, True, (4,), 12),
      ("L", "datt1", 1920, 1024, 1024, False, False, (2,), 12),
      ("L", "dx + gr1", 1920, 3072, 1024, False, True, (4,), 12)]
# (unit, label, R, M = width of x, N = width of dy, calls per unit)
DW = [("T", "dW1 = v2^T da1", 3840, 512, 2048, 6),
      ("T", "dW2 = h1d^T dy3", 3840, 2048, 512, 6),
      ("T", "dWqkv", 3840, 512, 1536, 6),
      ("T", "dWm1, dWq2, dWm2", 3840, 512, 512, 18),
      ("T", "enc dWqkv", 896, 512, 1536, 6),
      ("T", "enc dWm", 896, 512, 512, 6),
      ("T", "enc dW1", 896, 512, 2048, 6),
      ("T", "enc dW2", 896, 2048, 512, 6),
      ("L", "dW1", 1920, 1024, 4096, 12),
      ("L", "dW2", 1920, 4096, 1024, 12),
      ("L", "dWqkv", 1920, 1024, 3072, 12),
      ("L", "dWm1, dWq2, dWm2", 1920, 1024, 1024, 36)]


# (unit, label, M, K, N, static scale, relu, out size, calls per unit):
# every int8 site of one level-1 and one level-3 B=64 forward (encoder M
# 896, decoder 3840)
S8 = [("Q", f"{blk} L1 w1", M, 512, 2048, False, True, 4, 6)
      for blk, M in (("enc", 896), ("dec", 3840))]
S8 += [("Q", f"{blk} L1 w2", M, 2048, 512, False, False, 4, 6)
       for blk, M in (("enc", 896), ("dec", 3840))]
S8 += [("Q", f"{blk} L3 {site}", M, Kd, N, True, relu, osz,
        12 if (blk, site) == ("dec", "merge") else 6)
       for blk, M in (("enc", 896), ("dec", 3840))
       for site, Kd, N, relu, osz in (("qkv", 512, 1536, False, 2),
                                      ("merge", 512, 512, False, 4),
                                      ("w1", 512, 2048, True, 4),
                                      ("w2", 2048, 512, False, 4))]
S8.append(("Q", "dec L3 cross q", 3840, 512, 512, True, False, 2, 6))
# (unit, label, M, K, N, relu, out size, calls per unit): every int4 site of
# one B=1 and one B=64 forward at level 5 (W5) and level 7 (W7): the SA
# encoder blocks (M 14 / 896) and the SGA decoder blocks (60 / 3840), each
# qkv (bf16 out), w1 (ReLU; f32 out at level 5, bf16 at level 7) and w2
W4 = [(unit, f"{blk} {site}", M, Kd, N, relu,
       2 if site == "qkv" or (site == "w1" and unit == "W7") else 4, 6)
      for unit in ("W5", "W7")
      for blk, M in (("B1 enc", 14), ("B1 dec", 60), ("enc", 896),
                     ("dec", 3840))
      for site, Kd, N, relu in (("qkv", 512, 1536, False),
                                ("w1", 512, 2048, True),
                                ("w2", 2048, 512, False))]




def _ln_sites(unit, B, D):
    """gemm_ln's sites in one mode-0 forward (MCAN-small's 6 + 6 layers):
    (unit, label, M, K, D, f32 a, calls per unit)."""
    return [(unit, "dec merge", B * 60, D, D, True, 12),
            (unit, "enc merge", B * 14, D, D, True, 6),
            (unit, "dec ffn", B * 60, 4 * D, D, False, 6),
            (unit, "enc ffn", B * 14, 4 * D, D, False, 6)]


LN = (_ln_sites("M0", 64, 512) + _ln_sites("M0B1", 1, 512)
      + _ln_sites("H1536", 8, 1536) + _ln_sites("H2048", 8, 2048))
# (unit, label, B, L, D, calls per unit): attflat_pool at both AttFlats
ATTFLAT = [(unit, name, B, L, 512, 1) for unit, B in (("M0", 64),
                                                      ("M0B1", 1))
           for name, L in (("img", 60), ("lang", 14))]
# (unit, label, M, D, F): the streaming FFN + LN kernels, one call each
FFN = [("X", "MCAN-large B=64", 3840, 1024, 4096),
       ("XB1", "MCAN-large B=1", 60, 1024, 4096),
       ("XS", "MCAN-small B=64", 3840, 512, 2048)]


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / HBM) * 1e3


def int_mm_call(torch, aq, wq):
    """One torch._int_mm call on these operands (the int8 library
    yardstick, used nowhere in the port): the weight row-major, or in the
    column-major layout cuBLASLt's int8 products take, whichever this build
    accepts; None where it takes neither."""
    for w in (wq.contiguous(), wq.t().contiguous().t()):
        try:
            torch._int_mm(aq, w)
        except RuntimeError:
            continue
        return lambda: torch._int_mm(aq, w)
    return None


def eager_ms(torch, fn, calls: int = 50) -> float:
    """ms per eager call by CUDA events: the host's issue time counts."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_forward(torch, tag: str) -> None:
    """One MCAN-small Predictor forward at B = 1, 8 and 64: the default
    engine at int8 level 1 (no calibration) and at level 3 (calibrated on
    one batch), the int4 engine at level 5 and at level 7 (the same
    batch), and the bf16 engine (qffn=0)."""
    import statistics

    import numpy as np

    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data import build_vocab
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    cfg = Config()
    questions = ["what color is the cat", "is this a kitchen"]
    vocab, emb = build_vocab(questions)
    net = MCANet(cfg, len(vocab), 3129, pretrained_emb=emb,
                 generator=torch.Generator().manual_seed(0))
    state = net.state_dict()
    rng = np.random.default_rng(0)
    calib = ([questions[i % 2] for i in range(64)],
             [np.abs(rng.normal(size=(40, cfg.img_feat_size)))
              .astype(np.float32) for _ in range(64)])
    pred = Predictor(cfg, state, vocab, latency_buckets=(1, 8),
                     auto_calibrate=0)
    pred3 = Predictor(cfg, state, vocab, latency_buckets=(1, 8),
                      act_calibration=calib)
    pred5 = Predictor(cfg, state, vocab, latency_buckets=(1, 8),
                      engine="int4", act_calibration=calib)
    fwd, prep = build_production_engine(state, cfg.layer, cfg.multi_head,
                                        qffn=0)
    fwd7, prep7 = build_production_engine(
        state, cfg.layer, cfg.multi_head, qffn=7,
        act_scale_inputs=pred.pad_batch(*calib))
    for b in (1, 8, 64):
        feats = [np.abs(rng.normal(size=(40, cfg.img_feat_size)))
                 .astype(np.float32) for _ in range(b)]
        img, ques = pred.pad_batch([questions[i % 2] for i in range(b)],
                                   feats)
        img_t, ques_t = (torch.from_numpy(x).cuda() for x in (img, ques))

        def bf16():
            with torch.inference_mode():
                return fwd(prep, img_t, ques_t)

        def level7():
            with torch.inference_mode():
                return torch.sigmoid(fwd7(prep7, img_t, ques_t))

        engines = (("level 1", lambda: pred.forward_padded(img, ques)),
                   ("level 3", lambda: pred3.forward_padded(img, ques)),
                   ("int4 level 5", lambda: pred5.forward_padded(img, ques)),
                   ("int4 level 7", level7), ("bf16", bf16))
        t = {name: [] for name, _ in engines}
        for _ in range(5):
            for name, fn in engines:
                t[name].append(eager_ms(torch, fn, calls=10))
        for name, ms in t.items():
            print(json.dumps({"tag": tag, "forward": name, "B": b,
                              "ms": statistics.median(ms), "min_ms": min(ms),
                              "max_ms": max(ms)}), flush=True)
    time_mode0(torch, tag, cfg, state, vocab, emb, questions, rng,
               pred.pad_batch)


def time_mode0(torch, tag, cfg, state, vocab, emb, questions, rng,
               pad_batch) -> None:
    """The per-sub-op forward at B = 1, 8 and 64: MCAN-small's bf16 mode-0
    engine and the default Predictor at hidden 1536 (mode 0), eager (median
    of 5 rounds of 10 calls) and its engine as one CUDA graph (device time;
    null where the capture is refused), with the host-bound share."""
    import statistics

    import numpy as np

    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.cli.bench_layernorm import graph_ms
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    wide = Config.for_model("small", hidden_size=1536)
    wide_state = MCANet(wide, len(vocab), 3129, pretrained_emb=emb,
                        generator=torch.Generator().manual_seed(1)
                        ).state_dict()
    cases = []
    for label, c, sd in (("mode 0, MCAN-small", cfg, state),
                         ("default Predictor, hidden 1536", wide,
                          wide_state)):
        fwd, prep = build_production_engine(sd, c.layer, c.multi_head,
                                            qffn=0, sga_mode=0)
        pred = Predictor(c, sd, vocab, latency_buckets=(1, 8),
                         auto_calibrate=0) if c is wide else None
        cases.append((label, c, fwd, prep, pred))
    for b in (1, 8, 64):
        for label, c, fwd, prep, pred in cases:
            feats = [np.abs(rng.normal(size=(40, c.img_feat_size)))
                     .astype(np.float32) for _ in range(b)]
            img, ques = pad_batch([questions[i % 2] for i in range(b)],
                                  feats)
            img_t, ques_t = (torch.from_numpy(x).cuda() for x in (img, ques))

            def engine():
                with torch.inference_mode():
                    return fwd(prep, img_t, ques_t)

            call = (lambda: pred.forward_padded(img, ques)) if pred else \
                engine
            ms = [eager_ms(torch, call, calls=10) for _ in range(5)]
            try:
                dev_ms = graph_ms(torch, engine, calls=10, rounds=5)
            except RuntimeError:
                dev_ms = None
            med = statistics.median(ms)
            print(json.dumps({
                "tag": tag, "forward": label, "B": b, "ms": med,
                "min_ms": min(ms), "max_ms": max(ms), "graph_ms": dev_ms,
                "host_share": None if dev_ms is None else 1 - dev_ms / med}),
                flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--units", default="")
    args = ap.parse_args(argv)
    units = set(filter(None, args.units.split(",")))
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import mcan_vqa_tpu_torch
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.cli.bench_layernorm import graph_ms
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"mcan_vqa_tpu_torch was not imported from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    totals = {}

    def emit(kernel, unit, label, shape, calls, ms, mm_ms, b, **extra):
        t = totals.setdefault((kernel, unit), [0, 0.0, 0.0, 0.0])
        t[0] += calls
        t[1] += calls * ms
        t[2] = None if mm_ms is None or t[2] is None else t[2] + calls * mm_ms
        t[3] += calls * b
        print(json.dumps({"tag": args.tag, "kernel": kernel, "unit": unit,
                          "case": label, "shape": shape, "calls": calls,
                          "ms": ms, "mm_ms": mm_ms, "bound_ms": b, **extra}),
              flush=True)

    for unit, label, M, Kd, N, relu, osz, keep, calls in NN:
        if units and unit not in units:
            continue
        # shape [M, K, N]; mm_ms: torch.addmm with a bf16 bias
        a = randn(M, Kd, dtype=bf16)
        w = randn(Kd, N, dtype=bf16, s=Kd ** -0.5)
        b = randn(N, s=0.1)
        b16 = b.to(bf16)
        kw = dict(relu=relu, out_dtype=torch.float32 if osz == 4 else bf16)
        if keep == "mask":
            kw.update(mask=torch.rand(M, N, generator=g, device=dev) >= 0.1,
                      inv_keep=1 / 0.9)
        elif keep == "seeded":
            rows = 14 if M == 896 else 60       # rows per sample
            kw.update(mask=K.Philox(7, 0x303, 3865470566, rows),
                      inv_keep=2 ** 32 / 3865470566)
        nbytes = 2 * (M * Kd + Kd * N) + 4 * N + M * N * (
            osz + (keep == "mask"))
        extra = {}
        if unit == "B1":
            extra["eager_ms"] = eager_ms(torch, lambda: K.gemm_bias_act(
                a, w, b, **kw))
        emit("gemm_bias_act", unit, label, [M, Kd, N], calls,
             graph_ms(torch, lambda: K.gemm_bias_act(a, w, b, **kw)),
             graph_ms(torch, lambda: torch.addmm(b16, a, w)),
             bound_ms(2 * M * Kd * N, nbytes), **extra)
    for unit, label, M, Kd, N, has_gate, has_res, outs, calls in DX:
        if units and unit not in units:
            continue
        dy = randn(M, Kd, dtype=bf16)
        w = randn(N, Kd, dtype=bf16, s=Kd ** -0.5)
        kw = dict(gate=torch.relu(randn(M, N)).to(bf16) if has_gate else None,
                  inv_keep=1 / 0.9, res=randn(M, N) if has_res else None,
                  out_dtypes=tuple(torch.float32 if o == 4 else bf16
                                   for o in outs))
        nbytes = 2 * (M * Kd + N * Kd) + M * N * (2 * has_gate + 4 * has_res
                                                  + sum(outs))
        emit("gemm_dx", unit, label, [M, Kd, N], calls,
             graph_ms(torch, lambda: K.gemm_dx(dy, w, **kw)),
             graph_ms(torch, lambda: torch.mm(dy, w.t())),
             bound_ms(2 * M * Kd * N, nbytes))
    for unit, label, R, M, N, calls in DW:
        if units and unit not in units:
            continue
        x = randn(R, M, dtype=bf16)
        dy = randn(R, N, dtype=bf16, s=R ** -0.5)
        emit("gemm_dw", unit, label, [R, M, N], calls,
             graph_ms(torch, lambda: K.gemm_dw(x, dy)),
             graph_ms(torch, lambda: torch.mm(x.t(), dy)),
             bound_ms(2 * R * M * N, 2 * R * (M + N) + 4 * M * N))
    from mcan_vqa_tpu_torch.ops.quant import _quant_w
    for unit, label, M, Kd, N, static, relu, osz, calls in S8:
        if units and unit not in units:
            continue
        # the codes of a random activation, the weight as this checkout's
        # engines prepare it; mm_ms: torch._int_mm of the same operands
        aq = torch.randint(-127, 128, (M, Kd), generator=g, device=dev,
                           dtype=torch.int8)
        qw = _quant_w(randn(Kd, N, dtype=bf16, s=Kd ** -0.5))
        wq, sw, b = qw["w_q"], qw["w_scale"], randn(N, s=0.1)
        kw = dict(a=0.02) if static else dict(sx=randn(M).abs() * 0.01)
        kw.update(relu=relu, out_dtypes=(torch.float32 if osz == 4
                                         else bf16,))
        lib = int_mm_call(torch, aq, wq)
        nbytes = M * Kd + Kd * N + 8 * N + M * N * osz + (0 if static
                                                          else 4 * M)
        emit("gemm_s8", unit, label, [M, Kd, N], calls,
             graph_ms(torch, lambda: K.gemm_s8(aq, wq, sw, b, **kw)),
             graph_ms(torch, lib) if lib is not None else None,
             bound_ms(2 * M * Kd * N, nbytes, PEAK_INT8))
    from mcan_vqa_tpu_torch.ops.quant import _quant_w4
    for unit, label, M, Kd, N, relu, osz, calls in W4:
        if units and unit not in units:
            continue
        # the weight as this checkout's engines prepare it (int4, and int8
        # for the gemm_s8 yardstick); the codes of a random activation (W5)
        # or a bf16 activation (W7)
        w = randn(Kd, N, dtype=bf16, s=Kd ** -0.5)
        q4, q8 = _quant_w4(w), _quant_w(w)
        wp, s4, b = q4["w_p"], q4["w_gscale"], randn(N, s=0.1)
        odt = torch.float32 if osz == 4 else bf16
        aq = torch.randint(-127, 128, (M, Kd), generator=g, device=dev,
                           dtype=torch.int8)
        x = randn(M, Kd, dtype=bf16)
        wf = K.dequant_w4(wp, s4)
        s8 = graph_ms(torch, lambda: K.gemm_s8(
            aq, q8["w_q"], q8["w_scale"], b, a=0.02, relu=relu,
            out_dtypes=(odt,)))
        nn = graph_ms(torch, lambda: K.gemm_bias_act(x, wf, b, relu=relu,
                                                     out_dtype=odt))
        if unit == "W5":
            kernel, a_size, peak = "gemm_s4", 1, PEAK_INT8
            ms = graph_ms(torch, lambda: K.gemm_s4(
                aq, wp, s4, b, a=0.02, relu=relu, out_dtypes=(odt,)))
        else:
            kernel, a_size, peak = "gemm_w4bf16", 2, PEAK_BF16
            ms = graph_ms(torch, lambda: K.gemm_w4bf16(
                x, wp, s4, b, relu=relu, out_dtype=odt))
        nbytes = (a_size * M * Kd + Kd * N // 2 + 4 * (Kd // 128) * N + 4 * N
                  + M * N * osz)
        emit(kernel, unit, label, [M, Kd, N], calls, ms, None,
             bound_ms(2 * M * Kd * N, nbytes, peak), s8_ms=s8, nn_ms=nn)
        emit("gemm_s8, int8 weight", unit, label, [M, Kd, N], calls, s8,
             None, bound_ms(2 * M * Kd * N, nbytes + Kd * N // 2, PEAK_INT8))
        emit("gemm_bias_act, dequant weight", unit, label, [M, Kd, N], calls,
             nn, None, bound_ms(2 * M * Kd * N, nbytes + M * Kd * (2 - a_size)
                                + Kd * N * 3 // 2, PEAK_BF16))
    for unit, label, M, Kd, D, a_f32, calls in LN:
        if units and unit not in units:
            continue
        # the f32 a of a merge, the ReLU hidden of an FFN; a bf16 stream
        a = randn(M, Kd) if a_f32 else randn(M, Kd, dtype=bf16).relu()
        a16 = a.to(bf16)
        w = randn(Kd, D, dtype=bf16, s=Kd ** -0.5)
        b, res = randn(D, s=0.1), randn(M, D, dtype=bf16)
        gamma, beta = 1 + randn(D, s=0.1), randn(D, s=0.1)
        b16 = b.to(bf16)
        flops = 2 * M * Kd * D + 10 * M * D
        nbytes = a.element_size() * M * Kd + 2 * Kd * D + 12 * D + 4 * M * D
        ms = graph_ms(torch, lambda: K.gemm_ln(a, w, b, res, gamma, beta))
        pair = graph_ms(torch, lambda: K.residual_layernorm(
            res, K.gemm_bias_act(a16, w, b), None, gamma, beta, (bf16,)))
        extra = {"pair_ms": pair}
        if hasattr(K, "gemm_ln_plan"):
            p = K.gemm_ln_plan(M, Kd, D, a_f32)
            extra["plan"] = [p.bm, p.bn, p.cluster, p.grid, p.stages]
        emit("gemm_ln", unit, label, [M, Kd, D], calls, ms,
             graph_ms(torch, lambda: torch.addmm(b16, a16, w)),
             bound_ms(flops, nbytes), **extra)
        emit("gemm_ln, unfused pair", unit, label, [M, Kd, D], calls, pair,
             None, bound_ms(flops, nbytes + 8 * M * D))
    for unit, label, B, L, D, calls in ATTFLAT:
        if units and unit not in units:
            continue
        Fm = 512
        x = randn(B, L, D, dtype=bf16)
        h = randn(B * L, Fm).relu().to(bf16)
        w2, b2 = randn(Fm, 1, dtype=bf16, s=Fm ** -0.5), randn(1, s=0.1)
        lens = torch.tensor([(i * 7) % (L + 1) for i in range(B)], device=dev)
        mask = (torch.arange(L, device=dev)[None] >= lens[:, None])[
            :, None, None, :].contiguous()
        ops = 2 * B * L * Fm + 2 * B * L * D + 10 * B * L
        nbytes = (2 * B * L * Fm + 2 * Fm + 4 + B * L + 2 * B * L * D
                  + 2 * B * D + 4 * B * L)
        emit("attflat_pool", unit, label, [B, L, D], calls,
             graph_ms(torch, lambda: K.attflat_pool(h, w2, b2, mask, x)),
             None, bound_ms(ops, nbytes))
    for unit, label, M, D, F in FFN:
        if units and unit not in units:
            continue
        x = randn(M, D)
        w1 = randn(D, F, dtype=bf16, s=D ** -0.5)
        w2 = randn(F, D, dtype=bf16, s=F ** -0.5)
        b1, b2, beta = randn(F, s=0.1), randn(D, s=0.1), randn(D, s=0.1)
        gamma = 1 + randn(D, s=0.1)
        ops = (x, w1, b1, w2, b2, gamma, beta)
        xb, b1h, b2h = x.to(bf16), b1.to(bf16), b2.to(bf16)
        h = torch.relu(torch.addmm(b1h, xb, w1))
        flops = 4 * M * D * F + 10 * M * D
        nbytes = 4 * M * D + 4 * D * F + 4 * F + 12 * D + 4 * M * D
        extra = {
            "plain_ms": graph_ms(torch, lambda: K.ffn_ln_plain(*ops)),
            "pair_ms": graph_ms(torch, lambda: K.gemm_ln(K.gemm_bias_act(
                xb, w1, b1, relu=True, out_dtype=bf16), w2, b2, x, gamma,
                beta)),
            "addmm1_ms": graph_ms(torch, lambda: torch.addmm(b1h, xb, w1)),
            "addmm2_ms": graph_ms(torch, lambda: torch.addmm(b2h, h, w2))}
        mm = extra["addmm1_ms"] + extra["addmm2_ms"]
        for kernel in ("ffn_ln_blocked", "ffn_ln_wstationary"):
            fn = getattr(K, kernel)
            eager = eager_ms(torch, lambda: fn(*ops))
            if kernel == "ffn_ln_wstationary" and not hasattr(K,
                                                              "ffn_ln_plan"):
                ms, how = eager, "eager"   # a cooperative launch
            else:
                ms, how = graph_ms(torch, lambda: fn(*ops)), "graph"
            plan = {}
            if hasattr(K, "ffn_ln_plan"):
                variant = kernel[len("ffn_ln_"):]
                p = K.ffn_ln_plan(variant, M, D, F, True)
                plan["plan"] = [p.bn, p.cluster, p.f_width, p.f_steps,
                                p.splits, p.ts, p.clusters, p.grid, p.stages,
                                p.smem]
                if kernel == "ffn_ln_wstationary":
                    fn(*ops)
                    plan["last_grid"] = list(K.LAST_GRID[kernel])
            emit(kernel, unit, label, [M, D, F], 1, ms, mm,
                 bound_ms(flops, nbytes), timing=how, eager_ms=eager, **extra,
                 **plan)
    for (kernel, unit), (calls, ms, mm_ms, b) in totals.items():
        if calls == 0:
            continue
        print(json.dumps({"tag": args.tag, "kernel": kernel, "unit": unit,
                          "calls": calls, "ms": ms, "mm_ms": mm_ms,
                          "x_mm": ms / mm_ms if mm_ms else None,
                          "bound_ms": b}), flush=True)
    if args.forward:
        time_forward(torch, args.tag)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
