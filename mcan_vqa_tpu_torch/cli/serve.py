"""HTTP serving entrypoint (mcan_vqa_tpu/cli/serve.py): a VQA answer
service over the micro-batching frontend, on the card.

Completes the deployment stack: ``Predictor`` (or a serving artifact,
artifact.py) -> ``BatchingFrontend`` (dynamic micro-batching) -> this JSON
API. Stdlib-only (``http.server`` with a thread per connection): each
handler thread blocks on its request's future while the frontend
coalesces concurrent arrivals into one device batch, so HTTP concurrency
becomes batch occupancy on the card.

Endpoints::

    GET  /healthz     -> {"status": "ok"}
    GET  /stats       -> batching + model info
    POST /v1/answer   -> {"question": str, "image_feature": <feat>,
                          "top_k": int (optional, default 1, <= 32)}
                         => {"answer": str, "prob": float}
                            (+ "answers": [{"answer", "prob"}, ...] when
                             top_k > 1, highest probability first)
                      or {"requests": [{...}, ...]}
                         => {"results": [{"answer", "prob"} | {"error"}]}

``<feat>`` is a nested [regions, feat_size] list, or (4x smaller on the
wire) ``{"b64": base64(float32 bytes), "shape": [R, F]}``.

Status codes: 400 for a malformed body or request (bad JSON, a missing or
non-finite feature, bad b64, an empty batch, top_k outside [1, 32]), 404
for an unknown route, 413 for a body over ``--max_body_mb`` (refused
before it is read), 503 when ``--max_queue`` requests already wait, 504
when a request outlives ``--request_timeout_s``, 500 for an internal
failure. Inside a batch each item carries its own error.

Model sources (one required):
  --artifact DIR          a serving artifact (Predictor.export_artifact;
                          no model code on this path)
  --ckpt_path FILE        a reference pickle (.pkl / .pt / .pth), with
                          --vocab_json (token_to_ix) and --model / knobs;
                          an orbax directory is refused
  --synthetic             an MCANet seeded from --seed (smoke tests, no
                          files)

Every path runs on the card (``--device cuda``, the default); ``--device
cpu`` runs the kernels' plain versions on the CPU instead. An artifact
loads only on the device it was exported on.

``--calibrate sample.npz`` (arrays ``questions`` [N] str and ``features``
[N, R, F] float32, or an object array of ragged [R_i, F] blocks) bakes
static int8 activation scales into the fused engine
(``Predictor(act_calibration=...)``, level 3). Without it the fused engine
calibrates from live traffic (``--auto_calibrate N``, default 256; 0
disables): the first N finite request rows are buffered, a background
thread builds the level-3 engine, runs every bucket once and swaps it in;
``/stats`` reports the calibration state. Warm-up forwards are kept out
of the buffer. ``--q8aux`` adds the static-int8 aux sites once
calibrated. ``--calibrate`` and ``--q8aux`` are refused with
``--artifact`` (the exported engine is frozen), and ``--auto_calibrate``
is ignored there.

``--compile_cache`` is accepted and ignored (``utils/compile_cache.py``):
the JAX server's persistent XLA cache has no counterpart here. The kernels
are built by nvcc into the hash-keyed directory
``mcan_vqa_tpu_torch/_kernels_build/<key>/`` (ops/_build.py), which a
restarted server on the same checkout reuses, and the engines run eagerly,
so there is nothing else to compile.

Example::

    python -m mcan_vqa_tpu_torch.cli.serve --synthetic --port 8080
    python -m mcan_vqa_tpu_torch.cli.serve --artifact /path/to/artifact
    curl -s localhost:8080/v1/answer -d \
      '{"question": "what color is the cat", "image_feature": [[0.1, ...]]}'
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import signal
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from mcan_vqa_tpu_torch.batching import BatchingFrontend, FrontendOverloaded
from mcan_vqa_tpu_torch.cli.run_vqa import add_compile_cache_flag
from mcan_vqa_tpu_torch.utils import compile_cache

ARCH_KNOBS = ("hidden_size", "layer", "multi_head", "img_feat_size",
              "img_feat_pad_size", "flat_out_size", "flat_mlp_size",
              "max_token")


# ---------------------------------------------------------------------------
# request decoding


def decode_feature(obj) -> np.ndarray:
    """Nested-list or {"b64", "shape"} wire formats -> float32 [R, F]."""
    if isinstance(obj, dict):
        try:
            raw = base64.b64decode(obj["b64"], validate=True)
            shape = tuple(int(s) for s in obj["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad b64 feature: {e}") from e
        arr = np.frombuffer(raw, np.float32)
        if len(shape) != 2 or arr.size != shape[0] * shape[1]:
            raise ValueError(
                f"b64 payload has {arr.size} floats, shape {shape}")
        arr = arr.reshape(shape)
    else:
        arr = np.asarray(obj, np.float32)
    if arr.ndim != 2:
        raise ValueError(
            f"image_feature must be [regions, feat], got shape {arr.shape}")
    if not np.isfinite(arr).all():
        # NaN/Inf would propagate to every logit and argmax to garbage;
        # reject at the boundary where the caller can see it
        raise ValueError("image_feature contains non-finite values")
    return arr


_MAX_TOP_K = 32


def _parse_request(item) -> Tuple[str, np.ndarray, int]:
    if not isinstance(item, dict):
        raise ValueError("each request must be a JSON object")
    q = item.get("question")
    if not isinstance(q, str) or not q.strip():
        raise ValueError('"question" must be a non-empty string')
    if "image_feature" not in item:
        raise ValueError('missing "image_feature"')
    top_k = item.get("top_k", 1)
    if not isinstance(top_k, int) or isinstance(top_k, bool) \
            or not 1 <= top_k <= _MAX_TOP_K:
        raise ValueError(f'"top_k" must be an int in [1, {_MAX_TOP_K}]')
    return q, decode_feature(item["image_feature"]), top_k


# ---------------------------------------------------------------------------
# HTTP layer


class _Handler(BaseHTTPRequestHandler):
    # set by make_server on the handler class
    frontend: BatchingFrontend = None
    predictor = None
    request_timeout_s: float = 60.0
    max_body_bytes: int = 64 * 1024 * 1024
    quiet: bool = True
    protocol_version = "HTTP/1.1"
    # socketserver applies this to the connection (settimeout): a stalled
    # client (slow-loris headers or a body that never arrives) frees its
    # handler thread instead of pinning it for the server's lifetime —
    # without it the documented load-shedding story (max_queue -> 503)
    # can be defeated by N dead connections holding N threads
    timeout = 60.0

    def log_message(self, fmt, *args):  # noqa: D102
        if not self.quiet:
            sys.stderr.write("serve: " + fmt % args + "\n")

    # -- helpers ----------------------------------------------------------
    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # announced, not just enacted: clients see why their
            # keep-alive connection ends (body-not-consumed responses)
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        """Read the request body, bounded by max_body_bytes. Raises
        ValueError on a missing/garbled/oversized Content-Length (a cap
        violation must be rejected BEFORE reading, or a hostile client
        ties up a handler thread and the host's memory)."""
        raw = self.headers.get("Content-Length")
        try:
            length = int(raw)
        except (TypeError, ValueError):
            raise ValueError(f"bad Content-Length: {raw!r}") from None
        if not 0 <= length <= self.max_body_bytes:
            raise ValueError(
                f"body of {length} bytes exceeds the "
                f"{self.max_body_bytes}-byte limit")
        return self.rfile.read(length)

    # -- routes -----------------------------------------------------------
    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"})
        elif self.path == "/stats":
            fe = self.frontend
            self._send_json(200, {
                "batches_run": fe.batches_run,
                "requests_served": fe.requests_served,
                "mean_occupancy": fe.mean_occupancy,
                "latency_ms": fe.latency_ms(),
                "max_batch": self.predictor.max_batch,
                "img_feat_size": getattr(
                    self.predictor, "img_feat_size", None),
                "engine": getattr(self.predictor, "engine", "artifact"),
                # the live bucket -> engine table (every bucket "base"
                # in the port, which has no router yet)
                "routes": getattr(self.predictor, "routes", None),
                "calibration": getattr(self.predictor, "calibration",
                                       {"state": "off"}),
            })
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/answer":
            # responding WITHOUT consuming the body would desync a
            # keep-alive connection (the unread bytes would parse as the
            # next request line) — drop the connection instead
            self.close_connection = True
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            body = self._read_body()
        except ValueError as e:
            code = 413 if "exceeds" in str(e) else 400
            self.close_connection = True   # body not consumed (see above)
            self._send_json(code, {"error": str(e)})
            return
        try:
            payload = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._send_json(400, {"error": f"bad JSON: {e}"})
            return

        batch = isinstance(payload, dict) and "requests" in payload
        items = payload["requests"] if batch else [payload]
        if not isinstance(items, list) or not items:
            self._send_json(400, {"error": '"requests" must be a '
                                           'non-empty list'})
            return

        # Per-item semantics (the API contract: errors never fail the
        # whole batch): each item is parsed and, if valid, submitted in
        # order — a malformed item yields its own error entry while the
        # items already submitted still run. Submission stays inside one
        # loop so the valid items coalesce into as few device groups as
        # possible.
        futs, results = [], [None] * len(items)
        codes = [400] * len(items)
        for i, item in enumerate(items):
            try:
                q, feat, top_k = _parse_request(item)
                futs.append((i, self.frontend.submit(q, feat, top_k=top_k)))
            except FrontendOverloaded as e:
                results[i] = {"error": str(e)}
                codes[i] = 503
            except (ValueError, RuntimeError) as e:
                results[i] = {"error": str(e)}
        for i, fut in futs:
            try:
                res = fut.result(timeout=self.request_timeout_s)
                if isinstance(res, list):     # top_k > 1
                    results[i] = {"answers": [
                        {"answer": a, "prob": p} for a, p in res]}
                    results[i].update(results[i]["answers"][0])
                else:
                    ans, prob = res
                    results[i] = {"answer": ans, "prob": prob}
            except FuturesTimeout:
                # str(TimeoutError()) is "" — name the failure (a cold
                # first request can sit behind the kernels' first build
                # unless the server was started with warmup). 504, not
                # 400: retry middleware must see a server-side failure
                results[i] = {"error": f"request timed out after "
                                       f"{self.request_timeout_s:g}s"}
                codes[i] = 504
            except Exception as e:  # noqa: BLE001 — per-item failure
                # internal failure (frontend closed, device fault): 500
                results[i] = {"error": str(e) or type(e).__name__}
                codes[i] = 500

        if batch:
            self._send_json(200, {"results": results})
        elif "error" in results[0]:
            self._send_json(codes[0], results[0])
        else:
            self._send_json(200, results[0])


def make_server(predictor, host: str = "127.0.0.1", port: int = 0,
                max_wait_ms: float = 2.0,
                max_batch: Optional[int] = None,
                request_timeout_s: float = 60.0,
                max_queue: Optional[int] = 1024,
                max_body_bytes: int = 64 * 1024 * 1024,
                socket_timeout_s: float = 60.0,
                quiet: bool = True
                ) -> Tuple[ThreadingHTTPServer, BatchingFrontend]:
    """Build (server, frontend); port=0 picks an ephemeral port
    (``server.server_address[1]``). Caller runs ``serve_forever()`` and on
    shutdown calls ``server.shutdown()`` then ``frontend.close()``.
    Overload behavior: requests beyond ``max_queue`` waiting are rejected
    with 503 (load shedding beats unbounded queue growth); bodies beyond
    ``max_body_bytes`` are rejected with 413 before being read; a
    connection idle/stalled for ``socket_timeout_s`` is dropped (frees
    its handler thread — slow clients cannot pin the thread pool)."""
    frontend = BatchingFrontend(predictor, max_wait_ms=max_wait_ms,
                                max_batch=max_batch, max_queue=max_queue)
    handler = type("Handler", (_Handler,), {
        "frontend": frontend, "predictor": predictor,
        "request_timeout_s": request_timeout_s,
        "max_body_bytes": int(max_body_bytes), "quiet": quiet,
        "timeout": float(socket_timeout_s),
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server, frontend


# ---------------------------------------------------------------------------
# model construction


def _load_calibration(path: str):
    """--calibrate npz -> (questions list, features) for
    Predictor(act_calibration=...). ``features`` is [N, R, F] float32, or
    an object array of per-image [R_i, F] blocks (ragged region counts —
    the same formats predict_probs accepts)."""
    data = np.load(path, allow_pickle=True)
    missing = [k for k in ("questions", "features") if k not in data]
    if missing:
        raise SystemExit(f"--calibrate npz is missing arrays: {missing} "
                         f"(has {sorted(data.files)})")
    qs = [str(q) for q in data["questions"]]
    feats = data["features"]
    if feats.dtype == object:
        feats = [np.asarray(f, np.float32) for f in feats]
    else:
        feats = np.asarray(feats, np.float32)
    if len(qs) != len(feats):
        raise SystemExit(f"--calibrate: {len(qs)} questions vs "
                         f"{len(feats)} feature blocks")
    blocks = feats if isinstance(feats, list) else [feats]
    if any(not np.isfinite(b).all() for b in blocks):
        # a single NaN/Inf row would poison every static scale for the
        # server's whole lifetime
        raise SystemExit("--calibrate: sample contains non-finite feature "
                         "values; clean the npz before baking scales")
    return qs, feats


def build_predictor(args):
    if args.artifact:
        if args.calibrate:
            raise SystemExit("--calibrate does not apply to --artifact "
                             "(the exported engine is frozen; calibrate "
                             "at export time via Predictor("
                             "act_calibration=...).export_artifact)")
        if args.q8aux:
            raise SystemExit("--q8aux does not apply to --artifact "
                             "(the exported engine is frozen; pass "
                             "q8aux=True to the Predictor that exports)")
        from mcan_vqa_tpu_torch.artifact import load_artifact
        return load_artifact(args.artifact, device=args.device)

    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config

    overrides = {k: getattr(args, k) for k in ARCH_KNOBS
                 if getattr(args, k) is not None}
    cfg = Config.for_model(args.model, **overrides)
    buckets = (tuple(int(b) for b in args.latency_buckets.split(","))
               if args.latency_buckets else None)
    cal = _load_calibration(args.calibrate) if args.calibrate else None
    if cal is not None and args.engine not in ("auto", "fused", "int4"):
        print(f"[serve] note: --calibrate only affects the fused engine "
              f"(--engine {args.engine} ignores it)", file=sys.stderr)
        cal = None  # Predictor rejects calibration on non-fused engines
    kw = dict(max_batch=args.max_batch, engine=args.engine,
              latency_buckets=buckets, act_calibration=cal,
              q8aux=args.q8aux, auto_calibrate=args.auto_calibrate,
              device=args.device)

    if args.synthetic:
        import torch

        from mcan_vqa_tpu_torch.data import build_vocab, load_answer_dict
        from mcan_vqa_tpu_torch.models.net import MCANet
        tok, _ = build_vocab(
            ["what color is the cat dog red blue how many people"])
        a2i, _ = load_answer_dict()
        net = MCANet(cfg, token_size=len(tok), answer_size=len(a2i),
                     generator=torch.Generator().manual_seed(args.seed))
        return Predictor(cfg, net.state_dict(), tok, None, **kw)

    if not args.ckpt_path:
        raise SystemExit("one of --artifact / --ckpt_path / --synthetic "
                         "is required")
    if not args.vocab_json:
        raise SystemExit("--ckpt_path needs --vocab_json (token_to_ix)")
    with open(args.vocab_json) as f:
        token_to_ix = json.load(f)
    try:
        return Predictor.from_checkpoint(args.ckpt_path, cfg, token_to_ix,
                                         **kw)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="MCAN-VQA HTTP serving")
    p.add_argument("--artifact", help="serving artifact dir (artifact.py)")
    p.add_argument("--ckpt_path", help="reference pickle (.pkl/.pt/.pth)")
    p.add_argument("--vocab_json", help="token_to_ix JSON for --ckpt_path")
    p.add_argument("--synthetic", action="store_true",
                   help="MCANet seeded from --seed (smoke test, no files)")
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--engine", default="auto",
                   choices=["auto", "fused", "plain", "int8", "int4"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    add_compile_cache_flag(p)
    p.add_argument("--calibrate", metavar="NPZ",
                   help="traffic sample ('questions' strings + 'features' "
                        "[N, R, F] float32, or an object array of ragged "
                        "[R_i, F] blocks): bakes static int8 activation "
                        "scales into the fused engine (level 3). "
                        "Fused/auto/int4 engines only; not applicable to "
                        "--artifact")
    p.add_argument("--auto_calibrate", type=int, default=256,
                   help="without --calibrate, calibrate the fused "
                        "engine's static int8 scales from the first N "
                        "finite live request rows (background build + "
                        "bucket pre-run, then an atomic swap); 0 "
                        "disables; ignored for --artifact")
    p.add_argument("--q8aux", action="store_true",
                   help="once calibrated, also run the aux weight sites "
                        "(decoder cross-kv, AttFlat merges, head) with "
                        "static-int8 weights. Fused/int4 engines only")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--latency_buckets", type=str, default="1,8",
                   help='comma list, e.g. "1,8"; "" disables')
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--request_timeout_s", type=float, default=60.0)
    p.add_argument("--max_queue", type=int, default=1024,
                   help="reject (503) once this many requests are queued; "
                        "0 = unbounded")
    p.add_argument("--max_body_mb", type=float, default=64.0,
                   help="reject (413) request bodies larger than this")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the pre-listen warmup forwards (default: "
                        "every batch bucket runs one dummy forward BEFORE "
                        "the server accepts traffic, so no live request "
                        "waits for the kernels' build or a bucket's first "
                        "run)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    for knob in ARCH_KNOBS:
        p.add_argument(f"--{knob}", type=int)
    return p.parse_args(argv)


def warmup(predictor) -> None:
    """One dummy forward per batch bucket (blocking), with the online
    calibration paused: after this, every live request runs on built
    kernels and warmed buckets, and the dummies are not calibration
    rows."""
    cfg = getattr(predictor, "cfg", None)
    R = (int(cfg.img_feat_pad_size) if cfg is not None
         else int(predictor.meta["img_feat_pad_size"]))
    F = predictor.img_feat_size
    feat = np.zeros((R, F), np.float32)
    feat[0, 0] = 1.0
    pause = getattr(predictor, "calibration_paused", None)
    with (pause() if pause is not None else contextlib.nullcontext()):
        for b in predictor.buckets:
            t0 = time.perf_counter()
            predictor.predict_probs(["warmup"] * int(b), [feat] * int(b))
            print(f"warmup: bucket {b} ran in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    compile_cache.enable(args.compile_cache)
    predictor = build_predictor(args)
    if not args.no_warmup:
        warmup(predictor)
    server, frontend = make_server(
        predictor, args.host, args.port, max_wait_ms=args.max_wait_ms,
        request_timeout_s=args.request_timeout_s,
        max_queue=args.max_queue or None,
        max_body_bytes=int(args.max_body_mb * 1024 * 1024),
        quiet=not args.verbose)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(max_batch={predictor.max_batch}, "
          f"engine={getattr(predictor, 'engine', 'artifact')})", flush=True)

    def _stop(signum, frame):  # noqa: ARG001
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        frontend.close()
        print(f"served {frontend.requests_served} requests in "
              f"{frontend.batches_run} batches "
              f"(mean occupancy {frontend.mean_occupancy:.2f})", flush=True)


if __name__ == "__main__":
    main()
