"""A training roofline for the H100: the least time a train step could take
at the card's peaks, and the measured steps' share of it.

    python -m mcan_vqa_tpu_torch.cli.train_roofline [--models small,large]
        [--batch 64] [--ab FILE]

Counts, from a ``Config`` (token_size 20000, 3129 answers):

  * the forward's FLOPs per sample, product by product (2 per
    multiply-add): the image projection, the LSTM, each SA block (q / k / v,
    scores, P.V, merge, FFN), each SGA block (self q / k / v, scores, P.V
    and merge, cross q, cross k / v over the question, cross scores and
    P.V, merge, FFN), both AttFlats (MLP, pooling, merge) and the answer
    head -- the itemisation of docs/PERFORMANCE.md "Roofline sanity";
  * a train step as 3x the forward (each product once forward and twice
    backward: dX and dW); on its own line the backward's recompute in the
    train kernels the route runs: the attention of every fused block (the
    scores and P.V again), and at hidden 512, where the decoder does not
    save its projections (no ``att_saves``), the SGA block's six D x D
    projections and the SA block's four;
  * the bytes of weights and optimizer state a step moves: each f32
    parameter read by the forward and by the backward, its gradient written
    and read, AdamW reading the weight and both moments and writing all
    three back (10 x 4 bytes a parameter); activations are not counted.

The peaks are those PERF.md §6 bounds every kernel with, an H100 SXM's:
989 TFLOP/s bf16 dense on the tensor cores and 3.35 TB/s of HBM. The step's
bound is the larger of FLOPs / peak and bytes / rate. With ``--ab`` (a file
of ``bench_train_ab`` JSON lines) each measured config's step is set beside
the bound of its model: achieved TFLOP/s and its share of the bound. One
JSON line per model.
"""

from __future__ import annotations

import argparse
import json

PEAK_BF16 = 989e12          # FLOP/s, dense bf16, tensor cores (H100 SXM)
HBM = 3.35e12               # bytes/s
PEAK_SOURCE = "NVIDIA H100 SXM published peaks (989 TFLOP/s bf16 dense, " \
    "3.35 TB/s)"
TOKENS, ANSWERS = 20000, 3129
STEP_BYTES_PER_PARAM = 10 * 4


def forward_flops(cfg, answers: int = ANSWERS) -> dict:
    """Forward FLOPs per sample, itemised, and their "total"."""
    D, F, H = cfg.hidden_size, cfg.ff_size, cfg.multi_head
    T, R, E = cfg.max_token, cfg.img_feat_pad_size, cfg.word_embed_size
    M, G, O = cfg.flat_mlp_size, cfg.flat_glimpses, cfg.flat_out_size
    L = cfg.layer
    del H                                 # the heads split D: no change
    att_self_q = 2 * 2 * T * T * D        # scores and P.V
    sa = 2 * T * D * 3 * D + att_self_q + 2 * T * D * D + 2 * 2 * T * D * F
    sga_self = 2 * R * D * 3 * D + 2 * 2 * R * R * D + 2 * R * D * D
    sga_cross = (2 * R * D * D + 2 * 2 * T * D * D + 2 * 2 * R * T * D
                 + 2 * R * D * D)
    sga = sga_self + sga_cross + 2 * 2 * R * D * F

    def attflat(n):
        return 2 * n * D * M + 2 * n * M * G + 2 * n * D * G + 2 * G * D * O

    items = {
        "img_proj": 2 * R * cfg.img_feat_size * D,
        "lstm": 2 * T * 4 * D * (E + D),
        "sa_blocks": L * sa,
        "sga_blocks": L * sga,
        "attflat_and_head": attflat(T) + attflat(R) + 2 * O * answers,
    }
    items["total"] = sum(items.values())
    return items


def recompute_flops(cfg, route: dict) -> int:
    """FLOPs per sample the train kernels' backward recomputes on
    ``route`` (``trainer.engine_route``)."""
    D, T, R, L = cfg.hidden_size, cfg.max_token, cfg.img_feat_pad_size, \
        cfg.layer
    sga = 2 * 2 * R * (R + T) * D
    if not route["att_saves"]:
        sga += 2 * R * D * 6 * D
    sa = 2 * T * D * 4 * D + 2 * 2 * T * T * D \
        if route["fused_encoder"] else 0
    return L * (sga + sa)


def param_count(cfg, token_size: int = TOKENS,
                answers: int = ANSWERS) -> int:
    """MCANet's parameters, counted from the Config."""
    D, F, E = cfg.hidden_size, cfg.ff_size, cfg.word_embed_size
    M, G, O = cfg.flat_mlp_size, cfg.flat_glimpses, cfg.flat_out_size

    def dense(i, o):
        return i * o + o

    ffn = dense(D, F) + dense(F, D)
    sa = 4 * dense(D, D) + ffn + 2 * 2 * D
    sga = 8 * dense(D, D) + ffn + 3 * 2 * D
    attflat = dense(D, M) + dense(M, G) + dense(G * D, O)
    return (token_size * E + 4 * D * (E + D) + 8 * D
            + dense(cfg.img_feat_size, D) + cfg.layer * (sa + sga)
            + 2 * attflat + 2 * O + dense(O, answers))


def roofline(cfg, batch: int) -> dict:
    from mcan_vqa_tpu_torch.train.trainer import engine_route
    route = engine_route(cfg.hidden_size)
    fwd = forward_flops(cfg)
    params = param_count(cfg)
    step_flops = 3 * fwd["total"] * batch
    recompute = recompute_flops(cfg, route) * batch
    nbytes = STEP_BYTES_PER_PARAM * params
    flop_ms = (step_flops + recompute) / PEAK_BF16 * 1e3
    byte_ms = nbytes / HBM * 1e3
    return {"forward_gflop_per_sample": {k: v / 1e9 for k, v in fwd.items()},
            "params": params, "batch": batch,
            "step_gflop": step_flops / 1e9,
            "recompute_gflop": recompute / 1e9,
            "step_weight_and_optimizer_bytes": nbytes,
            "flop_ms": flop_ms, "byte_ms": byte_ms,
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "route": route, "peaks": PEAK_SOURCE}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="small,large")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ab", help="a file of bench_train_ab JSON lines")
    args = ap.parse_args(argv)
    from mcan_vqa_tpu_torch.configs import Config
    measured = []
    if args.ab:
        with open(args.ab) as f:
            measured = [json.loads(x) for x in f
                        if x.strip().startswith("{")]
        measured = [m for m in measured if m.get("bench") == "train_ab"]
    records = []
    for model in args.models.split(","):
        cfg = Config.for_model(model)
        record = dict(bench="train_roofline", model=model,
                      **roofline(cfg, args.batch))
        for m in measured:
            if m["model"] != model or m["B"] != args.batch:
                continue
            for name, c in m["configs"].items():
                if not c.get("ms"):
                    continue
                flops = (record["step_gflop"] + record["recompute_gflop"]) \
                    * 1e9
                record.setdefault("measured", {})[name] = {
                    "ms": c["ms"], "card": m.get("card"),
                    "achieved_tflop_s": flops / (c["ms"] / 1e3) / 1e12,
                    "share_of_bound": record["bound_ms"] / c["ms"]}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
