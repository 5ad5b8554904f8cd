"""HTTP generation service (counterpart of ``entrypoints/launch.py``).

Reference: ``entrypoints/launch.py:44-214``, a FastAPI app over Ray actors
exposing ``POST /generate``.  Here one process drives its rank's pipeline
(``xDiTParallel``) and the HTTP layer is the standard library's
``http.server``:

    POST /generate {"prompt": "...", "seed": 3, ...}
      -> {"images": ["<base64 png>"], "latency_s": ...}   (images)
      -> {"output": "<base64 npy>", ...}                  (latents)
    GET  /health -> {"status": "ok"}   (503 when the GPU does not answer)
    GET  /stats  -> requests, batches, the most requests packed in a call

Launch:  python -m compactfusion_tpu_torch.entrypoints.launch \\
             --model PixArt-alpha/PixArt-XL-2-512x512 --port 6000 --serve_batch 2
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
from compactfusion_tpu_torch.parallel_api import xDiTParallel
from compactfusion_tpu_torch.utils.image import png_bytes, to_uint8, write_png
from compactfusion_tpu_torch.utils.logger import init_logger

logger = init_logger(__name__)


class Engine:
    """Queued, batched serving.  The pipeline runs ``B = len(--prompt)``
    images a call (``serve_batch`` replicates the launch prompt out to B).
    One worker thread owns the device and drains a FIFO queue: up to B
    requests that arrive within a short window of the first are packed into
    the slots of one pipeline call; unfilled slots repeat the last request's
    prompt and are discarded.

    A request's ``seed`` is honoured exactly when its batch carries one
    distinct seed (always for a batch of one); with several, the smallest
    wins (the slots share the call's noise generator) and the response says
    so.  Without a seed each batch takes ``--seed`` plus a counter.
    """

    def __init__(self, args: xFuserArgs, serve_batch: int = 0, device: str = "cuda"):
        self.args = args
        engine_config, input_config = args.create_config()
        if serve_batch and serve_batch != len(input_config.prompt):
            reps = -(-serve_batch // len(input_config.prompt))
            input_config = dataclasses.replace(input_config,
                                               prompt=(tuple(input_config.prompt) * reps)[:serve_batch])
        self.runner = xDiTParallel(engine_config, input_config, device=device)
        #: the launch-time request config (per-request overrides never mutate it)
        self._base_input = self.runner.input_config
        self.batch_size = len(self._base_input.prompt)
        self.batch_window_s = 0.05
        self._queue: "queue.Queue" = queue.Queue()
        self._counter = 0
        self.stats = {"requests": 0, "batches": 0, "max_packed": 0}
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self.runner.prepare_run()
        self._worker.start()

    #: seconds a queued request may wait for the device before the HTTP
    #: layer answers 503
    request_timeout_s: float = 900.0

    def generate(self, request: dict) -> dict:
        fut: Future = Future()
        self._queue.put((request, fut))
        out, latency, shared_seed = fut.result(timeout=self.request_timeout_s)
        return self._format(out, request, latency, shared_seed)

    # --- health probing -----------------------------------------------------

    _health_cache = (0.0, True)  # (checked_at, healthy)
    _health_probe_s = 20.0
    _health_max_age_s = 30.0
    _probe_thread = None

    def _device_probe(self):
        """One small matmul on the runner's device, waited for."""
        dev = self.runner.device
        a = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)
        (a @ a).sum().item()

    def health(self) -> bool:
        """True iff the device answered a probe recently.  The probe runs in
        a daemon thread with a timeout, so a hung device turns into 503, not
        a hung ``GET /health``; results are cached for
        ``_health_max_age_s``, and no probe starts while one is stuck."""
        now = time.time()
        checked_at, healthy = self._health_cache
        if now - checked_at < self._health_max_age_s:
            return healthy
        if self._probe_thread is not None and self._probe_thread.is_alive():
            self._health_cache = (now, False)
            return False
        result = []
        t = threading.Thread(target=lambda: result.append(self._safe_probe()), daemon=True)
        self._probe_thread = t
        t.start()
        t.join(timeout=self._health_probe_s)
        healthy = bool(result and result[0])
        self._health_cache = (time.time(), healthy)
        return healthy

    def _safe_probe(self) -> bool:
        try:
            self._device_probe()
            return True
        except Exception:  # noqa: BLE001 - any device error = unhealthy
            return False

    # --- worker side -------------------------------------------------------

    def _serve_loop(self):
        while True:
            first = self._queue.get()
            if first is None:  # shutdown sentinel
                return
            batch = [first]
            deadline = time.time() + self.batch_window_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_batch(self, batch):
        inp = self._base_input
        B = self.batch_size
        prompts, negatives = list(inp.prompt), None
        for i, (req, _) in enumerate(batch):
            p = req.get("prompt")
            if isinstance(p, (list, tuple)):
                p = p[0] if p else None
            if isinstance(p, str):
                prompts[i] = p
            n = req.get("negative_prompt")
            if isinstance(n, (list, tuple)):
                n = n[0] if n else None
            if isinstance(n, str):
                if negatives is None:
                    negatives = list(inp.negative_prompt) * (B if len(inp.negative_prompt) == 1 else 1)
                negatives[i] = n
        for i in range(len(batch), B):  # pad: repeat the last real slot
            prompts[i] = prompts[len(batch) - 1]

        seeds = {req["seed"] for req, _ in batch if isinstance(req.get("seed"), int)}
        if seeds:
            seed = sorted(seeds)[0]
        else:
            self._counter += 1
            seed = inp.seed + self._counter
        shared_seed = len(seeds) > 1

        overrides = {"prompt": tuple(prompts), "seed": seed}
        if negatives is not None:
            overrides["negative_prompt"] = tuple(negatives)
        self.runner.input_config = dataclasses.replace(inp, **overrides)
        try:
            t0 = time.time()
            out = self.runner().float().cpu().numpy()  # waits for the device
            latency = time.time() - t0
        finally:
            self.runner.input_config = self._base_input
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["max_packed"] = max(self.stats["max_packed"], len(batch))
        for i, (_, fut) in enumerate(batch):
            fut.set_result((out[i:i + 1], latency, shared_seed))

    def close(self):
        self._queue.put(None)
        self._worker.join(timeout=5)

    # --- response formatting (HTTP thread side) ----------------------------

    def _format(self, out, request: dict, latency, shared_seed) -> dict:
        inp = self._base_input
        runtime_fields = {"prompt", "negative_prompt", "seed"}
        # size, steps and frames are fixed at launch: name them, since
        # accepting them silently would do nothing
        ignored = sorted(k for k in request if k in {f.name for f in dataclasses.fields(inp)}
                         and k not in runtime_fields)
        if shared_seed:
            ignored.append("seed (batched with a different seed)")
        if out.ndim == 4 and out.shape[-1] == 3:
            img8 = to_uint8(out)
            save_dir = request.get("save_disk_path")
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%d-%H%M%S")
                paths = []
                for i in range(img8.shape[0]):
                    p = os.path.join(save_dir, f"generated_image_{stamp}_{i}.png")
                    write_png(p, img8[i])
                    paths.append(p)
                resp = {"message": "Image generated successfully",
                        "output": paths if len(paths) > 1 else paths[0], "save_to_disk": True,
                        "shape": list(out.shape), "latency_s": round(latency, 3)}
            else:
                resp = {"images": [base64.b64encode(png_bytes(im)).decode() for im in img8],
                        "media_type": "image/png", "shape": list(out.shape), "latency_s": round(latency, 3)}
        else:
            buf = io.BytesIO()
            np.save(buf, out)
            resp = {"output": base64.b64encode(buf.getvalue()).decode(), "media_type": "application/x-npy",
                    "shape": list(out.shape), "latency_s": round(latency, 3)}
        if ignored:
            resp["ignored_fields"] = ignored
        return resp


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                if engine.health():
                    self._send(200, {"status": "ok"})
                else:
                    self._send(503, {"status": "unavailable", "error": "device backend unreachable"})
            elif self.path == "/stats":
                self._send(200, dict(engine.stats, batch_size=engine.batch_size, queued=engine._queue.qsize()))
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, {"error": "malformed Content-Length"})
                return
            try:
                request = json.loads(self.rfile.read(length) or b"{}")
                self._send(200, engine.generate(request))
            except TimeoutError:
                self._send(503, {"error": "generation timed out waiting for the device "
                                 f"({engine.request_timeout_s:.0f}s)"})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def log_message(self, *a):
            pass

    return Handler


def main():
    parser = FlexibleArgumentParser()
    xFuserArgs.add_cli_args(parser)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6000)
    parser.add_argument("--serve_batch", type=int, default=0,
                        help="images per pipeline call (queued requests are packed into these slots). "
                        "Default: len(--prompt).")
    ns = parser.parse_args()
    engine = Engine(xFuserArgs.from_cli_args(ns), serve_batch=ns.serve_batch)
    server = ThreadingHTTPServer((ns.host, ns.port), make_handler(engine))
    logger.info("serving on %s:%d", ns.host, ns.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
