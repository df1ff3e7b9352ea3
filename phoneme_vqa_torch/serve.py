"""Online serving CLI of the port, the counterpart of the root ``serve.py``:
dynamic-batched VQA answering over stdin/stdout or HTTP.

Requests are JSON lines on stdin::

    {"image_id": 3, "question": "tên cửa hàng là gì?"}        (optional "id")

and answers stream back as JSON lines on stdout, in completion order, tagged
with the request "id" (or the input line number)::

    {"id": 0, "answer": "phúc long"}

``--http PORT`` serves ``POST /answer``, ``POST /reload``, ``GET /stats``,
``GET /healthz`` and ``GET /metrics`` instead; SIGTERM or SIGINT stops
accepting, drains the requests in flight and exits 0.

Usage:
    python -m phoneme_vqa_torch.serve --config-file F [--ckpt best|last|none]
        [--device cuda|cpu] [--batch-size N] [--buckets 1,4|auto] [--continuous]
        [--horizon H] [--prefill-chunk C] [--spec K] [--adapter NAME=CKPT_DIR]
        [--aot DIR] [--prime] ...

The device is ``--device`` (default: the card), never the preset's
``DEVICE``. A preset is YAML or, where PyYAML is missing, JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from . import train  # noqa: F401  (registers the executors)
from .config import get_config
from .ops import _build
from .serving import ContinuousEngine, ServingEngine, aot
from .train import lora as lora_mod
from .train.checkpoint import CheckpointManager
from .utils.logger import get_logger
from .utils.registry import EXECUTORS

log = get_logger(__name__)

# the card's defaults: chip_smoke.py phase 15's grid on LaTr-base at 32
# slots (horizon 4/8/16 x prefill chunk 8/16) was fastest under a flood at
# 4 x 16 in both full runs on an H100 (PERF.md §6); 32 is the batch the
# card's serving numbers are taken at
DEFAULT_BATCH_SIZE = 32
DEFAULT_HORIZON = 4
DEFAULT_PREFILL_CHUNK = 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.serve")
    p.add_argument("--config-file", required=True)
    p.add_argument("--ckpt", default="best", choices=["best", "last", "none"],
                   help="checkpoint to serve ('none' = random init, for tests)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default), or the CPU when asked")
    p.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE,
                   help="the largest decode batch (continuous: the slot count)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--buckets", default=None, metavar="N,N,...",
                   help="extra decode batch shapes warmed up (graphs captured) at startup; "
                        "each gathered batch decodes at the smallest that fits. 'auto' = "
                        "powers of 4 below --batch-size")
    p.add_argument("--max-length", type=int, default=None,
                   help="decode length cap (default: config.max_predict_length)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP on PORT instead of stdin/stdout")
    p.add_argument("--max-queue", type=int, default=-1,
                   help=">0 bounds pending requests (values below 2x batch starve the "
                        "batcher: warned); -1 (default) derives 4x --batch-size; 0 = unbounded")
    p.add_argument("--cache-size", type=int, default=0,
                   help=">0 memoizes repeated (image_id, question) answers (LRU)")
    p.add_argument("--deadline-s", type=float, default=0, metavar="SECONDS",
                   help=">0 expires requests still queued after this many seconds")
    p.add_argument("--adapter", action="append", default=[], metavar="NAME=CKPT_DIR",
                   help="serve a LoRA adapter from a composite checkpoint (a LORA_RANK "
                        "training run's SAVE_PATH; best_ckp, else last_ckp) under NAME; "
                        'requests select it with an "adapter" field. One base model, many '
                        "fine-tunes. Repeatable; not with --continuous")
    p.add_argument("--confidence", action="store_true",
                   help="include a confidence field (geometric-mean emitted-token "
                        "probability) in every answer")
    p.add_argument("--access-log", default=None, metavar="FILE",
                   help="append one JSON line per request (status, latency_ms, bucket, "
                        "answer length; never the question text)")
    p.add_argument("--aot", default=None, metavar="DIR",
                   help="kernel store: load the built CUDA kernels from DIR at startup (no "
                        "nvcc); when DIR is missing or was packed for another environment, "
                        "build them and (re)pack DIR. The decode graphs are captured in every "
                        "process")
    p.add_argument("--prime", action="store_true",
                   help="build the kernels, capture every bucket's graphs, then exit 0")
    p.add_argument("--reload-every", type=float, default=0, metavar="SECONDS",
                   help=">0 polls the served checkpoint's mtime and hot-reloads new weights")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: slot-based decode with step-boundary refill "
                        "(all nine families; --batch-size becomes the slot count)")
    p.add_argument("--horizon", type=int, default=DEFAULT_HORIZON,
                   help="continuous mode: decode steps per dispatch (one graph replay)")
    p.add_argument("--prefill-chunk", type=int, default=DEFAULT_PREFILL_CHUNK,
                   help="continuous mode: rows per prefill")
    p.add_argument("--spec", type=int, default=None, metavar="K",
                   help="continuous mode: per-slot speculative decoding with K-token "
                        "prompt-lookup windows (identical answers). Defaults to the config's "
                        "SPEC_DECODE; 0 disables")
    return p.parse_args(argv)


def parse_buckets(spec, batch_size: int):
    if not spec:
        return None
    if spec == "auto":  # 1, 4, 16, ... below batch_size
        return [b for b in (4**i for i in range(8)) if b < batch_size]
    try:
        return [int(b) for b in spec.split(",") if b.strip()]
    except ValueError:
        raise SystemExit(f"--buckets expects N,N,... or 'auto', got {spec!r}")


def make_access_log(path: str):
    sink = open(path, "a", buffering=1, encoding="utf-8")
    lock = threading.Lock()

    def access_log(rec):
        with lock:  # records come from the worker AND submit threads
            sink.write(json.dumps(rec, ensure_ascii=False) + "\n")

    return access_log


def load_adapter(ckpt_dir: str, device=None) -> dict:
    """``{"lora", "scale"}`` from a composite LoRA checkpoint directory
    (best_ckp preferred, then last_ckp)."""
    ckpt = CheckpointManager(ckpt_dir)
    name = "best" if ckpt.exists("best") else "last"
    raw = ckpt.restore(name, device)
    if not lora_mod.is_composite(raw["params"]):
        raise SystemExit(f"{ckpt_dir}/{name}_ckp is not a LoRA composite checkpoint (train it "
                         "with LORA_RANK to produce adapters)")
    return {"lora": raw["params"]["lora"], "scale": float(raw.get("lora_scale", 1.0))}


def build_engine(args):
    if args.adapter and args.continuous:
        raise SystemExit("--continuous does not support --adapter")
    config = get_config(args.config_file)
    # serve mode: tokenizers + feature stores + model only; no QA CSV read
    ex = EXECUTORS.get(config.EXECUTOR)(config, mode="serve", device=args.device)
    aot_dir = args.aot if ex.device.type == "cuda" else None
    if args.aot and aot_dir is None:
        log.warning("(!) --aot ignored: the CPU path builds no kernels")
    loaded = aot.load(aot_dir) if aot_dir else []
    if args.prime and ex.device.type == "cuda":
        _build.build(*aot.KERNELS)
    if args.ckpt != "none":
        ex._load_trained_checkpoint(args.ckpt)
    ocr_store, obj_store = ex.serve_frames
    max_len = args.max_length or int(config.get("max_predict_length", 20))
    adapters = {}
    for spec in args.adapter:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--adapter expects NAME=CKPT_DIR, got {spec!r}")
        adapters[name] = load_adapter(path, ex.device)
        log.info(f"## adapter {name!r} loaded from {path}")
    access_log = make_access_log(args.access_log) if args.access_log else None
    if args.access_log:
        log.info(f"## access log -> {args.access_log}")
    if args.continuous:
        if args.buckets:
            raise SystemExit("--continuous does not support --buckets")
        spec_k = args.spec if args.spec is not None else int(config.get("SPEC_DECODE", 0) or 0)
        engine = ContinuousEngine(
            ex, ocr_store, obj_store, num_slots=args.batch_size,
            prefill_chunk=args.prefill_chunk, horizon=args.horizon, max_answer_length=max_len,
            max_queue=args.max_queue, default_deadline_s=args.deadline_s,
            access_log=access_log, confidence=args.confidence, cache_size=args.cache_size,
            spec_k=spec_k)
    else:
        engine = ServingEngine(
            ex, ocr_store, obj_store, batch_size=args.batch_size,
            max_wait_ms=args.max_wait_ms, max_answer_length=max_len,
            max_queue=args.max_queue, cache_size=args.cache_size,
            confidence=args.confidence, default_deadline_s=args.deadline_s,
            adapters=adapters or None, buckets=parse_buckets(args.buckets, args.batch_size),
            access_log=access_log)
    # (re)pack when the store does not hold every kernel built now
    if aot_dir and not set(aot.built()) <= set(loaded):
        aot.pack(aot_dir)
    return engine


def make_http_server(engine, port: int):
    """HTTP front end over the engine (stdlib, a thread per request; each
    handler blocks on its future while the engine batches across them):
    POST /answer {"image_id", "question"} -> {"answer"}; POST /reload; GET
    /stats, /healthz, /metrics."""
    from concurrent.futures import TimeoutError as FutureTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        # graceful shutdown: server_close() waits for the handler threads
        # (which may be blocked on engine futures) so their responses are
        # written before the process exits
        daemon_threads = False
        block_on_close = True

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                reason = getattr(engine, "unhealthy_reason", None)
                if reason:  # the stall watchdog fired: a dead device behind us
                    self._send(503, {"ok": False, "reason": reason})
                else:
                    self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, engine.stats())
            elif self.path == "/metrics":
                body = engine.prometheus_metrics().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/reload":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n)) if n else {}
                    loadtype = str(body.get("ckpt", "best"))
                    if loadtype not in ("best", "last"):
                        return self._send(400, {"error": "ckpt must be 'best' or 'last'"})
                    return self._send(200, engine.reload(loadtype))
                except FileNotFoundError as e:
                    return self._send(404, {"error": str(e)})
                except Exception as e:
                    return self._send(500, {"error": str(e)})
            if self.path != "/answer":
                return self._send(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
            except Exception as e:
                return self._send(400, {"error": f"bad request body: {e}"})
            if not isinstance(req, dict) or "image_id" not in req or "question" not in req:
                return self._send(400, {"error": "image_id and question fields required"})
            if not isinstance(req["image_id"], (str, int, float)):
                return self._send(400, {"error": "image_id must be a string or number"})
            if not isinstance(req.get("deadline_s", 0), (int, float)):
                return self._send(400, {"error": "deadline_s must be a number"})
            if req.get("adapter") is not None and not isinstance(req["adapter"], str):
                return self._send(400, {"error": "adapter must be a string"})
            try:
                ans = engine.submit(req["image_id"], str(req["question"]),
                                    deadline_s=req.get("deadline_s"),
                                    adapter=req.get("adapter")).result(timeout=120)
                self._send(200, ans if isinstance(ans, dict) else {"answer": ans})
            except KeyError as e:  # unknown image
                self._send(404, {"error": str(e)})
            except RuntimeError as e:  # queue full / engine stopped
                self._send(503, {"error": str(e)})
            except (TimeoutError, FutureTimeout) as e:  # expired deadline or wedged decode
                self._send(504, {"error": str(e) or "decode timed out"})
            except Exception as e:
                self._send(500, {"error": str(e)})

    return _Server(("", port), Handler)


def start_reload_watcher(engine, loadtype: str, every_s: float):
    """Polls the served checkpoint's mtime every ``every_s`` seconds and
    hot-reloads when a trainer writes a new one (checkpoints are renamed
    into place, so a changed mtime is a complete file). A daemon thread."""
    ckpt = engine.executor.ckpt
    last = {"mtime": ckpt.mtime(loadtype)}

    def watch():
        while not engine._stopped:
            time.sleep(every_s)
            try:
                m = ckpt.mtime(loadtype)
                if m is not None and m != last["mtime"]:
                    engine.reload(loadtype)
                    last["mtime"] = m
            except Exception as e:  # keep watching; a reload can be retried
                log.warning(f"reload watcher: {e!r}")

    t = threading.Thread(target=watch, daemon=True, name="reload-watcher")
    t.start()
    return t


def serve_http(engine, port: int) -> None:
    import signal

    srv = make_http_server(engine, port)
    # SIGTERM/SIGINT: stop accepting, drain the batches in flight, exit 0
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: threading.Thread(target=srv.shutdown, daemon=True).start())
    log.info(f"## HTTP SERVING on :{srv.server_port} (POST /answer, /reload; GET /stats, "
             "/healthz, /metrics)")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()  # waits for the handler threads
        engine.stop()
        log.info(f"## serving stats: {engine.stats()}")


def serve_stdin(engine) -> None:
    out_lock = threading.Lock()
    # in flight only: done futures discard themselves
    pending = set()
    log.info("## SERVING (ctrl-d to drain and exit) ...")

    def respond(req_id, fut):
        try:
            res = fut.result()
            obj = {"id": req_id, **res} if isinstance(res, dict) else \
                {"id": req_id, "answer": res}
        except Exception as e:
            obj = {"id": req_id, "error": str(e)}
        with out_lock:
            print(json.dumps(obj, ensure_ascii=False), flush=True)

    for i, raw in enumerate(sys.stdin):
        raw = raw.strip()
        if not raw:
            continue
        req = None
        try:
            req = json.loads(raw)
            fut = engine.submit(req["image_id"], str(req["question"]),
                                deadline_s=req.get("deadline_s"), adapter=req.get("adapter"))
        except Exception as e:
            rid = req.get("id", i) if isinstance(req, dict) else i
            respond(rid, _failed(e))
            continue
        req_id = req.get("id", i)
        pending.add(fut)
        fut.add_done_callback(lambda f, rid=req_id: (respond(rid, f), pending.discard(f)))
    for fut in list(pending):  # drain before exit
        try:
            fut.result()
        except Exception:
            pass
    engine.stop()
    log.info(f"## serving stats: {engine.stats()}")


def _failed(e):
    from concurrent.futures import Future

    f = Future()
    f.set_exception(e)
    return f


def main(argv=None):
    args = parse_args(argv)
    t0 = time.monotonic()
    engine = build_engine(args)
    log.info(f"## ready to answer in {time.monotonic() - t0:.1f} s")
    if args.prime:
        engine.stop()
        log.info("## primed (kernels built, decode graphs captured"
                 + (f", kernel store at {args.aot}" if args.aot else "") + "); exiting")
        return
    if args.reload_every > 0 and args.ckpt != "none":
        start_reload_watcher(engine, args.ckpt, args.reload_every)
    if args.http is not None:
        serve_http(engine, args.http)
    else:
        serve_stdin(engine)


if __name__ == "__main__":
    main()
