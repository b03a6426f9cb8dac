"""Serving throughput and latency through the whole HTTP stack on the card
(tools/bench_serve_http.py of the JAX package, on the H100).

MCAN-small at its published widths with seeded random weights behind
``cli/serve.py``'s server and ``BatchingFrontend``, fed by K concurrent
HTTP clients with features at the real wire shape [60, 2048] f32 (491 KB
a request; ~655 KB as b64), so
parsing, decoding, padding, the input copies and the forward cost what
they cost in production. The card is local here, so no relay stands
between the stack and the device and the real engine is measured, not a
tiny stand-in.

Reported per wire format (b64 vs nested JSON lists), one JSON line each:
  qps                requests/s answered 200 through HTTP
  p50 / p95 / p99    submit -> resolve latency (ms) from the frontend's own
                     clock (queueing, coalescing wait, forward, copy back)
  occupancy          requests per device batch (coalescing effectiveness)
  card               nvidia-smi's name and power limit

Clients pre-serialize one request body and reuse it, so client-side cost
is the HTTP send; clients and server share the host's cores, so qps is a
lower bound on what a dedicated serving host sustains.

    python -m mcan_vqa_tpu_torch.cli.bench_serve_http [--seconds 10] \\
        [--clients 16] [--formats b64,list]

The engine is the default Predictor's at level 3 (calibrated on a seeded
batch first: the steady state of online calibration), buckets 1, 8 and
64. It needs the card; ``bench`` serves any predictor (chip_smoke.py
benches a serving artifact with it too).
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json
import subprocess
import threading
import time

import numpy as np

SEED = 0
QUESTIONS = ["what color is the cat", "how many people are in the picture",
             "is this a kitchen", "what is the man holding"]


def card_name() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def seeded_features(rng, n: int, regions: int, feat: int):
    """n ragged [R_i, F] features, |N(0, 1)|, 10 to ``regions`` rows."""
    return [np.abs(rng.normal(size=(int(r), feat))).astype(np.float32)
            for r in rng.integers(10, regions + 1, n)]


def build_predictor():
    """MCAN-small with seeded weights, the default engine at level 3
    (calibrated on a seeded batch of 64 requests)."""
    import torch

    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data import build_vocab
    from mcan_vqa_tpu_torch.models.net import MCANet

    cfg = Config()
    vocab, emb = build_vocab(QUESTIONS)
    net = MCANet(cfg, len(vocab), 3129, pretrained_emb=emb,
                 generator=torch.Generator().manual_seed(SEED))
    cal = ([QUESTIONS[i % len(QUESTIONS)] for i in range(64)],
           seeded_features(np.random.default_rng(SEED), 64,
                           cfg.img_feat_pad_size, cfg.img_feat_size))
    return Predictor(cfg, net.state_dict(), vocab, max_batch=64,
                     latency_buckets=(1, 8), act_calibration=cal)


def one_body(fmt: str, feat: np.ndarray) -> bytes:
    if fmt == "b64":
        payload = {"b64": base64.b64encode(feat.tobytes()).decode(),
                   "shape": list(feat.shape)}
    else:
        payload = feat.tolist()
    return json.dumps({"question": "what color is the cat",
                       "image_feature": payload}).encode()


def run_format(addr, fmt: str, feat: np.ndarray, seconds: float,
               clients: int, frontend) -> dict:
    """K clients post one body over and over for ``seconds``."""
    body = one_body(fmt, feat)
    stop = time.monotonic() + seconds
    counts = [0] * clients
    errors = [0] * clients

    def client(i: int) -> None:
        conn = http.client.HTTPConnection(*addr, timeout=120)
        while time.monotonic() < stop:
            conn.request("POST", "/v1/answer", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                counts[i] += 1
            else:
                errors[i] += 1
        conn.close()

    frontend.reset_stats()
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.monotonic() - t0
    lat = frontend.latency_ms()
    return {"format": fmt, "qps": sum(counts) / dt,
            "errors": sum(errors), "clients": clients,
            "p50_ms": lat["p50"], "p95_ms": lat["p95"],
            "p99_ms": lat["p99"], "occupancy": frontend.mean_occupancy,
            "wire_kb": len(body) / 1024.0}


def bench(predictor, seconds: float, clients: int, formats, regions: int,
          max_wait_ms: float = 2.0):
    """Serve ``predictor`` on an ephemeral port, warm every bucket and the
    HTTP path, then one ``run_format`` per wire format -> their dicts."""
    from mcan_vqa_tpu_torch.cli import serve as serve_mod

    serve_mod.warmup(predictor)
    srv, frontend = serve_mod.make_server(predictor, port=0,
                                          max_wait_ms=max_wait_ms)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = srv.server_address[:2]
        feat = np.abs(np.random.default_rng(SEED).normal(
            size=(regions, predictor.img_feat_size))).astype(np.float32)
        run_format(addr, "b64", feat, 1.0, clients, frontend)
        return [run_format(addr, fmt, feat, seconds, clients, frontend)
                for fmt in formats]
    finally:
        srv.shutdown()
        srv.server_close()
        frontend.close()
        thread.join(timeout=10)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--formats", default="b64,list")
    ap.add_argument("--regions", type=int, default=60)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve_http measures the card: no CUDA "
                         "device")
    predictor = build_predictor()
    card = card_name()
    for r in bench(predictor, args.seconds, args.clients,
                   args.formats.split(","), args.regions, args.max_wait_ms):
        print(json.dumps(dict(r, engine="level 3", card=card)), flush=True)


if __name__ == "__main__":
    main()
